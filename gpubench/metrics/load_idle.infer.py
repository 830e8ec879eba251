"""load_idle.infer: the share of the traced window in which the device is
idle while s5's main thread waits for the loader's next shard
(`nsp.s5.load_wait`). Layer: stage. Moves infer_sites_s."""
from _spans import idle_inside


def read(ctx):
    return idle_inside(ctx, ["nsp.s5.load_wait"])

"""write_idle.infer: the share of the traced window in which the device is
idle while s2's main thread waits for the device worker's next shard or
the decode pool's next task (`nsp.s2.write_wait`): s2's cost a shard that
the device does not hide. Layer: stage. Moves infer_sites_s."""
from _spans import idle_inside


def read(ctx):
    return idle_inside(ctx, ["nsp.s2.write_wait"])

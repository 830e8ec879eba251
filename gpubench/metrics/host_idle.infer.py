"""host_idle.infer: the share of the traced window in which the device is
idle while s5's main thread does host work: `nsp.s5.list` (each shard
opened for its contig), `nsp.s5.pool` (deferral, padding, casts,
reference codes, pooling), `nsp.s5.drain` (a batch's fetch and CSV
lines) or `nsp.s5.write` (a contig's rows sorted and written). Layer:
stage. Moves infer_sites_s."""
from _spans import idle_inside


def read(ctx):
    return idle_inside(ctx, ["nsp.s5.list", "nsp.s5.pool", "nsp.s5.drain",
                             "nsp.s5.write"])

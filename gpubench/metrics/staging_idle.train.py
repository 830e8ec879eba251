"""staging_idle.train: the share of the traced window in which the device
is idle while the trainer's main thread is inside `nsp.train.convert`
(host_batch of a group's batches) or `nsp.group.stage` (waiting on the
slot's last copy, filling pinned staging and the scalar table). Layer:
group runner. Moves train_samples_s."""
from _spans import idle_inside


def read(ctx):
    return idle_inside(ctx, ["nsp.train.convert", "nsp.group.stage"])

"""feed_idle.train: the share of the traced window in which the device is
idle while the trainer's main thread is inside `nsp.train.feed` (the
iterator's next batch, until it is in its buffer: the epoch reloads of
haplotype_train_iterator, the gather of batch_iterator). Layer: trainer
host. Moves train_samples_s."""
from _spans import idle_inside


def read(ctx):
    return idle_inside(ctx, ["nsp.train.feed"])

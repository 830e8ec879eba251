"""h2d_bytes.train: the bytes the group runner's staging copies move to
the device (counter `nsp.h2d_bytes`) over the traced window's samples:
bytes a sample, a count. Layer: group runner. Moves train_samples_s."""
from _spans import per


def read(ctx):
    return per("nsp.h2d_bytes", ctx, "samples")

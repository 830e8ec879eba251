"""mfu.train: the whole step's share of the card's bf16 peak: the model's
FLOP over the window (three times the forward FLOP a sample times samples) over the
window's seconds at 989 TFLOP/s. Layer: model. Moves
train_samples_s."""
from _common import mfu


def read(ctx):
    return mfu(ctx, train=True)

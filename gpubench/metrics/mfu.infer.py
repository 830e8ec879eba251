"""mfu.infer: the whole step's share of the card's bf16 peak: the model's
FLOP over the window (forward FLOP a site times the sites that ran
the model: s5's deferred sites do not) over the window's seconds at 989 TFLOP/s. Layer: model. Moves
infer_sites_s."""
from _common import mfu


def read(ctx):
    return mfu(ctx, train=False)

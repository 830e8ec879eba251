"""lstm_roofline.train: the port's BiLSTM kernels' share of their roofline
over the window: the sum of each call's bound (work/: the larger of
FLOP / 989 TFLOP/s and bytes / 3.35 TB/s, from the call's shapes) over
the device time of those kernels in the trace. Layer: kernels. Moves
train_samples_s."""
from _common import roofline


def read(ctx):
    return roofline(ctx)

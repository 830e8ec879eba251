"""conv_roofline.train: the CatModel's conv tower against its roofline:
the sum of the bounds of the window's tower calls (work/_conv_tower.py:
each convolution's forward, input- and weight-gradient product, the
larger of FLOP / 67 TFLOP/s, f32 FFMA, and bytes / 3.35 TB/s) over the
device time of the cuDNN kernels that ran them, in per cent. Layer:
kernels. Moves train_samples_s."""
import harness


def read(ctx):
    tower = harness.load_module("work", "_conv_tower")
    bound, t = tower.window_bound(ctx), tower.device_seconds(ctx)
    if bound is None or t is None:
        return None
    return 100.0 * bound / t

"""conv_share.train: the device time of the CatModel's conv tower
kernels (work/_conv_tower.py's KERNELS: cuDNN's forward, input- and
weight-gradient convolutions) as a per cent of the traced window. Layer:
model. Moves train_samples_s."""
import harness


def read(ctx):
    tower = harness.load_module("work", "_conv_tower")
    if tower.window_bound(ctx) is None:
        return None
    t = tower.device_seconds(ctx)
    return None if t is None else 100.0 * t / ctx.trace.window_s

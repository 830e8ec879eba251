"""device_idle.infer: the share of the traced window in which no kernel,
copy or set ran on the card (the union of the device intervals over all
streams, so overlapping streams count once). Layer: device. Moves
infer_sites_s."""


def read(ctx):
    if not ctx.trace.device:
        return None
    return ctx.trace.idle_share()

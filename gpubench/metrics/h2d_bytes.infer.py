"""h2d_bytes.infer: the bytes that s5 stages for the device (counter
`nsp.h2d_bytes`: the featurizer's int8 and int16 read matrices and
reference codes) over the traced window's sites that reach the model:
bytes a site, a count. Layer: stage. Moves infer_sites_s."""
from _spans import per


def read(ctx):
    return per("nsp.h2d_bytes", ctx, "model_rows")

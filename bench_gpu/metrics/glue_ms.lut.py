"""`glue_ms.lut`: device ms per batch of every kernel that is not one of
the program's own, in the LUT cascade (torch ops: pads, unpacking, stage
mixes, un-shift adds); moves `out_mpix_s`."""


def read(ctx):
    s = ctx.glue_s()
    return 1e3 * s if s > 0 else None

"""`glue_ms.net`: device ms per batch of every kernel that is not one of
the program's own, in net mode (torch ops: the permutes and the scaling
to [0, 1], the tap matrices, pads, stage mixes, the pixel shuffle, round
and clamp); moves `out_mpix_s`."""


def read(ctx):
    s = ctx.glue_s()
    return 1e3 * s if s > 0 else None

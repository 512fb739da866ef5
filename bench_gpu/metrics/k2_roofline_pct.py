"""`k2_roofline_pct`: K2's least time per batch (`work/lut.py`) over its
device time per batch, in %; moves `out_mpix_s`."""

KERNELS = ("tail_assemble_kernel",)


def read(ctx):
    return ctx.roofline_pct("k2_bound_s", KERNELS)

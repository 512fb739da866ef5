"""`k1_roofline_pct`: K1's least time per batch (`work/lut.py`) over its
device time per batch, its six calls summed, in %; moves `out_mpix_s`."""

KERNELS = ("window_fold_kernel", "window_quad_sum_kernel")


def read(ctx):
    return ctx.roofline_pct("k1_bound_s", KERNELS)

"""`k4_roofline_pct`: K4's least time per batch (`work/net_dense.py`:
the larger of its flops over the bf16 tensor-core peak and its bytes over
the bandwidth, per stage) over its device time per batch, both stages
summed, in %; moves `out_mpix_s`."""

KERNELS = ("dense_kernel",)


def read(ctx):
    return ctx.roofline_pct("k4_bound_s", KERNELS)

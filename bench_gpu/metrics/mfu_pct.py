"""`mfu_pct`: the least time the card could take for a batch (`work/<kind>.py`:
the model's useful operations over the peak, or the batch's compulsory
bytes over the bandwidth, whichever is larger) over the traced run's mean
host time per batch, in %; moves `out_mpix_s`."""


def read(ctx):
    return 100.0 * ctx.work["step_bound_s"] / ctx.batch_s

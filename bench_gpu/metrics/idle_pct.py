"""`idle_pct`: share of the traced window in which no kernel or copy ran
on the device, streams merged, in %; moves `out_mpix_s`."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)

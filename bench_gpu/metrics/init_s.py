"""`init_s`: host seconds of the program's construction at set-up (the
tables cached and prepared, or the weight stacks built), ended by a
synchronize; moves `setup_s`."""


def read(ctx):
    return ctx.init_s

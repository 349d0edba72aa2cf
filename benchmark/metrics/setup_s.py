"""setup_s: from the start of the benchmark's process to the first timed
call: imports, build or load of the hand kernels, discretization, the
online step's frozen preconditioner and coarse space, and the warm-up calls
(host clock)."""


def read(ctx):
    return ctx.setup_s

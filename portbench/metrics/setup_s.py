"""Process start to the first timed epoch (host clock): imports, the CUDA
context, the data from the seed, the kernel libraries (built on a
checkout's first run), the Trainer, and the first epoch and test boundary
of the CLI loop."""


def read(ctx):
    return ctx.setup_s

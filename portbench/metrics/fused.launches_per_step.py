"""Device kernels started in the profiled periods outside their test
boundaries (copies and sets not counted), per training step (device
trace)."""

from portbench import trace


def read(ctx):
    steps = sum(r.steps for r in ctx.profiled_rounds())
    kernels = [s for s in ctx.training_spans() if trace.is_kernel(s)]
    if not steps or not kernels:
        return None
    return len(kernels) / steps

"""The conv weight-gradient stage's least time (counts.wgrad_step, a step,
times the profiled steps) over the device time given to its kernels
(kernels/<config>.json's 'wgrad' names; each instant of the trace given
to the earliest-started kernel running then, since a kernel started by
programmatic dependent launch waits inside its span), in %."""

from portbench import counts, trace


def read(ctx):
    names = tuple(ctx.kernel_map.get("wgrad", ()))
    steps = sum(r.steps for r in ctx.profiled_rounds())
    if not names or not steps:
        return None
    owned = trace.attributed_us(
        [s for s in ctx.training_spans() if trace.is_kernel(s)])
    us = sum(t for k, t in owned.items() if k.startswith(names))
    if us <= 0:
        return None
    n_bytes, flops = counts.wgrad_step(ctx.net)
    return 100.0 * counts.bound_s(n_bytes * steps, flops * steps,
                                  ctx.peaks) / (us * 1e-6)

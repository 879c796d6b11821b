"""The training step's share of the chip's float32 peak: the training
operations of the traced run's window without its profiled periods
(counts.step_flops a step; the eval forwards are not counted) over those
periods' wall time (host clock) times the float32 rate outside the tensor
cores (peaks.json), in %."""

from portbench import counts


def read(ctx):
    rounds = ctx.unprofiled()
    wall = sum(r.period_s for r in rounds)
    if not rounds or wall <= 0:
        return None
    flops = counts.step_flops(ctx.net) * sum(r.steps for r in rounds)
    return 100.0 * flops / (wall * ctx.peaks["f32_flops_per_s"])

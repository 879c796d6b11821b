"""1 - the union of every device span over the profiled periods' wall time
(host clock from the profiler's start to the synchronize after the last
period), in %."""

from portbench import trace


def read(ctx):
    if ctx.wall_us <= 0 or not ctx.dev_spans:
        return None
    return 100.0 * (1.0 - trace.union_us(ctx.dev_spans) / ctx.wall_us)

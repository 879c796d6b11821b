"""The median host time of one test boundary of the CLI loop (the two
evaluate calls and save_checkpoint, ended by torch.cuda.synchronize()),
over the traced run's window without its profiled periods."""

import statistics


def read(ctx):
    ms = [(b - a) * 1e3 for r in ctx.unprofiled() for name, a, b in r.spans
          if name == "test_boundary"]
    return statistics.median(ms) if ms else None

"""The 95th percentile, over the window's test periods, of a period's wall
time (from dispatching its first epoch to its checkpoint written) over its
epochs, in ms (host clock; linear interpolation between order
statistics)."""

import numpy as np


def read(ctx):
    per_epoch = [r.period_s * 1e3 / r.epochs for r in ctx.rounds]
    return float(np.percentile(per_epoch, 95))

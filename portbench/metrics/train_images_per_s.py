"""Training images completed in the measured window over the window's
wall time (host clock); the test boundaries' eval and checkpoints are
inside the window, as they are for a user of the CLI."""


def read(ctx):
    return (sum(r.steps for r in ctx.rounds) * ctx.net.batch
            / ctx.window_s)

"""The least time the chip could take for the profiled epochs' training
work (counts: operations at the float32 rate, or each input read and each
output written once at the HBM rate, whichever is longer) over the device
time those epochs' operations took (the union of the spans outside the
test boundaries; device trace), in %."""

from portbench import counts, trace


def read(ctx):
    rounds = ctx.profiled_rounds()
    busy_us = trace.union_us(ctx.training_spans())
    if not rounds or busy_us <= 0:
        return None
    steps = sum(r.steps for r in rounds)
    epochs = sum(r.epochs for r in rounds)
    least = counts.bound_s(counts.epoch_bytes(ctx.net, steps // epochs)
                           * epochs, counts.step_flops(ctx.net) * steps,
                           ctx.peaks)
    return 100.0 * least / (busy_us * 1e-6)

"""Operations and bytes of the training work, counted from a net's shapes.

The benchmark's own counts (``netdesc.Net``), never the program's:

  * ``step_flops``: one training step, a copy of ``chip_smoke.py``'s
    ``step_flops`` for the benchmark's grammar: each conv level's forward,
    weight gradient and (below the first level) input gradient, the dense
    products forward, weight and input gradient, 2 operations a
    multiply-add, and 10 a state element for the regularised momentum
    update. The eval forwards are not counted.
  * ``epoch_bytes``: an epoch's inputs read once and outputs written once:
    the step rows and labels, the noise words, the state and momenta read
    and written, the per-step (cost, minf) pairs.
  * ``wgrad_step``: one step's conv weight-gradient stage (``chip_smoke.py``
    ``stage_bounds``' first kind): it reads dz and the level's input and
    writes the weights' and bias's gradients.
  * ``bound_s``: the least time for such work on a chip, the larger of the
    operations at the chip's float32 rate and the bytes at its HBM rate.
"""

from __future__ import annotations


def state_elements(net):
    return sum(r * c for r, c in net.state_shapes())


def step_flops(net):
    B = net.batch
    products = [(B * lv.maps * (lv.filt * lv.side_conv) ** 2 * lv.cin, k > 0)
                for k, lv in enumerate(net.levels)]
    widths = [net.n_flat, net.n_hid, net.n_out]
    products += [(B * a * b, True) for a, b in zip(widths, widths[1:])]
    flops = sum(2 * macs * (3 if dgrad else 2) for macs, dgrad in products)
    return flops + 10 * state_elements(net)


def epoch_bytes(net, n_steps):
    B, C0, HW = net.batch, net.in_ch, net.hw
    per_step = (C0 * B * HW + B                  # step rows, labels
                + 8 + 4 * HW + C0 * B * HW + B * net.n_hid   # words
                + 2)                             # (cost, minf) written
    return 4 * (n_steps * per_step + 4 * state_elements(net))


def wgrad_step(net):
    """(bytes, operations) of one step's conv weight gradients."""
    n_bytes = flops = 0
    for lv in net.levels:
        taps = lv.filt * lv.filt * lv.cin
        out = net.batch * lv.maps * lv.side_conv ** 2
        flops += 2 * out * taps + out
        n_bytes += 4 * (out + net.batch * lv.cin * lv.side_in ** 2
                        + lv.maps * (taps + 1))
    return n_bytes, flops


def bound_s(n_bytes, flops, peaks):
    """The least seconds for the work: max(bytes / HBM rate, operations /
    float32 rate)."""
    return max(n_bytes / peaks["hbm_bytes_per_s"],
               flops / peaks["f32_flops_per_s"])

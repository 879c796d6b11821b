"""The comparison that decides a run's ``correct``.

The program's outputs, taken from the timed path at the timed sizes:

  * set-up builds the one ``Trainer`` the window then drives and runs the
    CLI loop's first round through it: epoch 0 (one ``run_epochs`` call,
    every step on its own rows) and its test boundary. From that round
    come each step's loss, the state and momenta after the epoch (the
    program exposes its state only where a ``run_epochs`` call ends, so
    after the epoch's last step), and the boundary's eval statistics;
  * the window's last test boundary gives its eval statistics and the
    state they were taken on;
  * once the window has closed, one more round of the loop (not timed):
    the epoch after the window, trained from the state and momenta the
    window left, and its boundary.

The reference (``reference.py``) starts from the seed and follows epoch 0
step by step in float32 from its own initial weights and noise words.
The epoch after the window it follows from the program's state and
momenta at the window's close (the program's own state: the reference
cannot train the window's hundreds of epochs in a run's time), at the
rate of the LR schedule and with the noise words of that epoch as the
reference counts it. Compared, each against its limit in
``workloads/<cell>.json``:

  * ``loss_gap`` / ``loss_gap_after``: the largest relative gap of steps
    1-3's losses of epoch 0 / of the epoch after the window;
  * ``change_gap`` / ``change_gap_after``: the median leaf's gap between
    the norms of the program's and the reference's change of the state
    over that epoch, each leaf's gap a share of the reference's norm of
    that leaf or of the median leaf, whichever is larger. Leaves whose
    first gradient in the reference is under a thousandth of the median
    leaf's are left out (none are, in the benchmark's configuration). The
    median, not the worst leaf: over an epoch's hundreds of free-running
    steps two sound float32 runs drift apart leaf by leaf (``change_worst``
    and ``mom_gap``, the worst leaf's gap of epoch 0's change and of the
    momenta after it, are reported and not compared; PERF.md gives their
    readings);
  * ``eval_wrong``: the largest gap, in samples, between the wrong answers
    the program's eval reported and the reference's eval forward on the
    program's state, over both windows of the first and the last test
    boundary of the window and of the round after it (the eval is judged
    on the program's own state: its trained state is what it evaluates);
  * ``eval_p_gap``: the same boundaries' relative gap of the mean
    true-class probability.
"""

from __future__ import annotations

import numpy as np
import torch

from . import noise, reference
from .reference import F32

NUMBERS = ("loss_gap", "change_gap", "loss_gap_after", "change_gap_after",
           "eval_wrong", "eval_p_gap")
N_LOSSES = 3


def learning_rate(tr, epoch):
    """INIT / (1 + epoch / EPOCHS_TO_HALF_RATE) (theanet's
    neuralnet.py:303-307)."""
    return tr["INIT_LEARNING_RATE"] / (1 + epoch / tr["EPOCHS_TO_HALF_RATE"])


def step_rows(net, x, y, device, half_batch=False):
    """The training set as step rows (``reference.arrange``). ``half_batch``
    leaves out the second half of every batch, the loss and gradients the
    mean over the first half (a fault the comparison has to catch)."""
    xs, ys = reference.arrange(net, x, y, device)
    if half_batch:
        h, B = net.batch // 2, net.batch
        xs = xs.reshape(xs.shape[0], net.in_ch, B, -1).clone()
        xs[:, :, h:2 * h] = xs[:, :, :h]
        xs = xs.reshape(xs.shape[0], net.in_ch * B, -1).contiguous()
        ys = ys.clone()
        ys[:, h:2 * h] = ys[:, :h]
    return xs, ys


def follow(net, tr, seed, epoch, start, moms, rows, P=F32, n_epochs=1,
           lr_epoch=None, noise_epoch=None):
    """The reference's epochs ``epoch`` .. ``epoch + n_epochs - 1`` from the
    leaves ``start`` and ``moms`` on the step ``rows``: dict(start, state,
    moms, costs and grad1 of the first epoch). ``lr_epoch`` and
    ``noise_epoch`` put another epoch's rate or noise words in (faults the
    comparison has to catch)."""
    xs, ys = rows
    state, first = start, None
    for e in range(epoch, epoch + n_epochs):
        e_lr = e if lr_epoch is None else lr_epoch
        e_noise = e if noise_epoch is None else noise_epoch
        bits = noise.epoch_noise_bits(seed, e_noise, net, xs.shape[0],
                                      xs.device)
        state, moms, costs, grad1 = reference.train_epoch(
            net, state, moms, xs, ys, bits, learning_rate(tr, e_lr), P)
        first = first or (costs.cpu().numpy(), grad1)
    return dict(start=start, state=state, moms=moms, costs=first[0],
                grad1=first[1])


def first_epoch(net, layers, tr, seed, rows, P=F32):
    """The reference's epoch 0 from the seed (its own initial weights)."""
    init = reference.to_leaves(reference.init_framework(layers, net, seed),
                               net, rows[0].device)
    return follow(net, tr, seed, 0, init, [torch.zeros_like(t) for t in init],
                  rows, P)


def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog, ref, keep):
    """[(gap, leaf index)] of the leaves ``keep``: |‖prog_i‖ - ‖ref_i‖|
    over max(‖ref_i‖, median ‖ref‖)."""
    np_, nr = [_norm(t) for t in prog], [_norm(t) for t in ref]
    med = float(np.median([nr[i] for i in keep]))
    return [(abs(np_[i] - nr[i]) / max(nr[i], med, 1e-30), i) for i in keep]


def eval_window(net, xs, ys, ids, device):
    """The images and labels of a window of whole batches ``ids``."""
    B = net.batch
    idx = torch.as_tensor(np.concatenate(
        [np.arange(b * B, (b + 1) * B) for b in ids]), device=device)
    return xs[idx], ys[idx]


def eval_gaps(net, boundaries, data, P=F32):
    """(largest wrong-answer gap, largest relative gap of the mean
    true-class probability) of the program's eval statistics at
    ``boundaries`` against the reference's eval forward of the state each
    was taken on."""
    wrong_gap = p_gap = 0.0
    for b in boundaries:
        for which in ("test", "train"):
            xs, ys = data[which]
            x, y = eval_window(net, xs, ys, b[which + "_ids"], xs.device)
            err, p, wrong = reference.eval_stats(net, b["state"], x, y, P)
            p_err, p_p = b[which]
            wrong_gap = max(wrong_gap,
                            abs(round(p_err * x.shape[0] / 100.0) - wrong))
            p_gap = max(p_gap, abs(p_p - p) / max(abs(p), 1e-30))
    return float(wrong_gap), float(p_gap)


def epoch_gaps(prog, ref):
    """(loss gap, median leaf's change gap, [(change gap, leaf)], leaves
    kept) of the program's epoch ``prog`` (dict of its step ``losses`` and
    the ``state`` it ended in) against the reference's ``follow`` of the
    same epoch from the same start."""
    g = [_norm(t) for t in ref["grad1"]]
    med = float(np.median(g))
    keep = [i for i, v in enumerate(g) if v >= 1e-3 * med]
    losses = np.asarray(prog["losses"], np.float64)[:N_LOSSES]
    rl = ref["costs"][:N_LOSSES].astype(np.float64)
    loss_gap = float(np.max(np.abs(losses - rl) / np.abs(rl)))
    change = leaf_gaps([p - s for p, s in zip(prog["state"], ref["start"])],
                       [r - s for r, s in zip(ref["state"], ref["start"])],
                       keep)
    return (loss_gap, float(np.median([c for c, _ in change])), change,
            keep)


def readings(net, ref, prog, ref_after, prog_after, boundaries, data):
    """The compared numbers of the program's epoch 0 ``prog`` (dict of its
    step ``losses``, its ``state`` and ``moms``), its epoch after the
    window ``prog_after`` (``losses``, ``state``) and its test
    ``boundaries`` against the reference's ``first_epoch`` ``ref`` and its
    ``follow`` of the epoch after the window ``ref_after``. Returns
    ({number: value}, {number: what it was read on})."""
    names = net.leaf_names()
    loss_gap, change_gap, change, keep = epoch_gaps(prog, ref)
    worst, ci = max(change)
    mom, mi = max(leaf_gaps(prog["moms"], ref["moms"], keep))
    loss_after, change_after, _, _ = epoch_gaps(prog_after, ref_after)
    wrong, pg = eval_gaps(net, boundaries, data)
    values = dict(loss_gap=loss_gap, change_gap=change_gap,
                  loss_gap_after=loss_after, change_gap_after=change_after,
                  change_worst=worst, mom_gap=mom, eval_wrong=wrong,
                  eval_p_gap=pg)
    where = dict(change_worst=names[ci], mom_gap=names[mi],
                 left_out=[names[i] for i in range(len(names))
                           if i not in keep])
    return values, where


def checks(values, limits):
    """[(name, value, limit)] in NUMBERS' order, and whether every value is
    within its limit (a NaN is not)."""
    rows = [(k, values[k], limits[k]) for k in NUMBERS]
    return rows, all(v <= lim for _, v, lim in rows)

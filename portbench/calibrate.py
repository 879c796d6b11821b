"""The readings a cell's limits are set from, on the chip.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--seconds 51]

For each seed, in one process: the cell's set-up as a run makes it (the
data, the ``Trainer``, the CLI loop's first round), ``--seconds`` of the
loop as a run's window drives it, and the round after it, then the
compared numbers (``compare.py``) of

  * ``program``: the port, as a run reads it (the lower readings);
  * ``control``: the reference in TF32 (``reference.TF32``: every
    product's operands rounded to TF32) put in the program's place (the
    upper readings);
  * ``half_batch``: the float32 reference in the program's place with the
    second half of every batch left out, the loss and gradients the mean
    over the first half (a fault);
  * ``lr_epoch0`` and ``noise_epoch0``: the float32 reference in the
    program's place, the epoch after the window trained at epoch 0's rate
    or with epoch 0's noise words (faults of the LR schedule and of the
    epoch counter);
  * ``witness``: the reference with its dense and gradient products summed
    in float64 (``reference.F32_ACC64``), another sound float32 run, in
    the program's place: how far two sound runs drift apart over an
    epoch, and how far a sound eval in another summation order reads.

Each stand-in trains epoch 0 from the seed and the epoch after the window
from the program's state at the window's close, as the reference does;
its eval statistics come from the eval forward of its own states on the
first and the last boundary's windows, in its own precision. Two faults
need no run: a step that returns its state unchanged reads 1 as
``change_gap`` (no change against the reference's), and an eval answer
altered where it is produced (one sample's prediction) reads 1 as
``eval_wrong``. One JSON line a seed and reading goes to standard output.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

STAND_INS = {
    "control": dict(P="TF32"),
    "half_batch": dict(half_batch=True),
    "lr_epoch0": dict(lr_epoch=0),
    "noise_epoch0": dict(noise_epoch=0),
    "witness": dict(P="F32_ACC64"),
}


def calibrate(cell_name, seeds, seconds=51.0, device="cuda",
              out=sys.stdout):
    import torch

    from . import cells, compare, harness, reference
    from .loop import Loop
    from .netdesc import net_from_layers

    cell = cells.cell(cell_name)
    cfg = cells.config(cell["config"])
    dev = torch.device(device)
    layers = cells.layers(cfg)
    rows = []
    for seed in seeds:
        data = harness.make_data(cfg, seed)
        x, y, xt, yt = data
        net, trainer, tr = harness.build_trainer(cfg, cell, seed, data, dev)
        desc = net_from_layers(layers, tr["BATCH_SZ"], x.shape[3],
                               x.shape[1])
        with tempfile.TemporaryDirectory() as ckpt:
            loop = Loop(trainer, tr, ckpt, "calibrate")
            r0 = loop.round()
            prog = dict(losses=r0.costs[0].copy(),
                        state=reference.to_leaves(trainer.params, desc, dev),
                        moms=reference.to_leaves(trainer.moms, desc, dev))
            first = dict(r0.boundary, state=prog["state"])
            e_after, t0 = r0.epochs, time.perf_counter()
            while True:
                r = loop.round()
                e_after += r.epochs
                if time.perf_counter() - t0 >= seconds:
                    break
            start = reference.to_leaves(trainer.params, desc, dev)
            moms = reference.to_leaves(trainer.moms, desc, dev)
            last = dict(r.boundary, state=start)
            r_after = loop.round()
            prog_after = dict(losses=r_after.costs[0].copy(),
                              state=reference.to_leaves(trainer.params, desc,
                                                        dev))
            after = dict(r_after.boundary, state=prog_after["state"])
            loop.close()
        del loop, trainer, net
        dd = {"test": (torch.as_tensor(xt, device=dev),
                       torch.as_tensor(yt, device=dev)),
              "train": (torch.as_tensor(x, device=dev),
                        torch.as_tensor(y, device=dev))}
        sd, n_after = tr["SEED"], r_after.epochs
        t0 = time.perf_counter()
        sound = compare.step_rows(desc, x, y, dev)
        ref = compare.first_epoch(desc, layers, tr, sd, sound)
        ref_after = compare.follow(desc, tr, sd, e_after, start, moms, sound,
                                   n_epochs=n_after)
        ref_s = time.perf_counter() - t0
        values, where = compare.readings(desc, ref, prog, ref_after,
                                         prog_after, [first, last, after],
                                         dd)
        emit(out, rows, cell_name, seed, "program", values, where,
             epoch_after=e_after, reference_s=ref_s)

        for what, kw in STAND_INS.items():
            P = getattr(reference, kw.get("P", "F32"))
            steps = (compare.step_rows(desc, x, y, dev, half_batch=True)
                     if kw.get("half_batch") else sound)
            alt = (ref if "lr_epoch" in kw or "noise_epoch" in kw else
                   compare.first_epoch(desc, layers, tr, sd, steps, P))
            alt_after = compare.follow(
                desc, tr, sd, e_after, start, moms, steps, P,
                n_epochs=n_after, lr_epoch=kw.get("lr_epoch"),
                noise_epoch=kw.get("noise_epoch"))
            bounds = []
            for b, state in ((first, alt["state"]),
                             (after, alt_after["state"])):
                b = dict(b, state=state)
                for which in ("test", "train"):
                    xs, ys = dd[which]
                    xw, yw = compare.eval_window(desc, xs, ys,
                                                 b[which + "_ids"], dev)
                    b[which] = reference.eval_stats(desc, state, xw, yw,
                                                    P)[:2]
                bounds.append(b)
            values, where = compare.readings(
                desc, ref,
                dict(losses=alt["costs"], state=alt["state"],
                     moms=alt["moms"]), ref_after,
                dict(losses=alt_after["costs"], state=alt_after["state"]),
                bounds, dd)
            emit(out, rows, cell_name, seed, what, values, where)
        del ref, ref_after, alt, alt_after, dd
    return rows


def emit(out, rows, cell_name, seed, what, values, where, **extra):
    row = dict(cell=cell_name, seed=seed, reading=what, **values,
               worst_change=where["change_worst"], worst_mom=where["mom_gap"],
               **extra)
    rows.append(row)
    print(json.dumps(row), file=out, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=51.0,
                    help="how long the loop runs before the round after it")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 3
    calibrate(args.workload, [int(s) for s in args.seeds.split(",")],
              args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())

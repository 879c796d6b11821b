"""One run of one cell: set-up, the measured window, the traced periods,
the comparison, the result.

Set-up makes the cell's data from the seed (``data/<generator>.py``),
builds the port's kernels (``ops._build.build``, timed apart: only a
checkout's first run compiles), the net from the config's layer list
(``NeuralNet``, initial weights from the seed) and the ``Trainer`` on the
device, and runs the CLI loop's first round (``loop.py``): epoch 0 and its
test boundary, which warms every shape the window uses and gives the
comparison its first readings. The window then runs rounds of the loop
until ``seconds`` have passed; a round that starts inside the window runs
to its end. With ``trace``, the first round that starts after half the
window and the ones after it, ``trace_periods`` in all, run under
torch.profiler. After the window: one more round of the loop from the
state the window left (not timed; the comparison follows it), the
device's memory peak is read, the program is freed, the trace is reduced,
the reference follows epoch 0 and the round after the window and judges
the program's outputs (``compare.py``), and the metric readers
(``metrics/<name>.py``) read the run.
"""

from __future__ import annotations

import gc
import os
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

from . import cells, compare, trace as trace_mod
from .reference import to_leaves
from .netdesc import net_from_layers

NUM_EPOCHS = 10 ** 6        # the run is longer than any window


def norm_seed(seed):
    """The seed as the program's SEED: numpy's RandomState takes 32 bits."""
    return int(seed) % 2 ** 32


def data_seed(seed):
    return int(np.random.SeedSequence([norm_seed(seed), 1]).generate_state(
        1, np.uint32)[0])


@dataclass
class Ctx:
    """What the metric readers read."""
    net: object
    peaks: dict
    kernel_map: dict
    setup_s: float
    window_s: float
    rounds: list                      # the window's rounds (loop.Round)
    profiled: list = field(default_factory=list)   # their indices
    dev_spans: list = field(default_factory=list)  # profiled device spans
    host_ranges: list = field(default_factory=list)
    wall_us: float = 0.0              # the profiled periods' host wall
    t0_us: float = 0.0                # its start in the trace's clock

    def unprofiled(self):
        skip = set(self.profiled)
        return [r for i, r in enumerate(self.rounds) if i not in skip]

    def boundary_ranges(self):
        return [(a, b) for name, a, b in self.host_ranges
                if name == "test_boundary"]

    def training_spans(self):
        """Device spans of the profiled periods outside test boundaries."""
        return trace_mod.inside(self.dev_spans, self.boundary_ranges())[1]

    def profiled_rounds(self):
        return [self.rounds[i] for i in self.profiled]


def make_data(cfg, seed):
    d = cfg["data"]
    return cells.generator(d["generator"])(
        cfg["train_images"], cfg["test_images"], d["img_sz"], data_seed(seed))


def training_params(cfg, cell, seed):
    tr = dict(cfg["training_params"])
    tr.update(cell.get("training_params", {}))
    tr["SEED"] = norm_seed(seed)
    tr["NUM_EPOCHS"] = NUM_EPOCHS
    return tr


def build_trainer(cfg, cell, seed, data, device):
    """(NeuralNet, Trainer, training params) of the cell, as the CLI builds
    them from a .prms file and a data module."""
    from theanet_tpu_torch.model import NeuralNet
    from theanet_tpu_torch.trainer import Trainer

    layers = cells.layers(cfg)
    tr = training_params(cfg, cell, seed)
    x, y, xt, yt = data
    layers[0][1]["img_sz"] = x.shape[3]
    if "num_maps" not in layers[0][1] and x.shape[1] != 1:
        layers[0][1]["num_maps"] = x.shape[1]
    net = NeuralNet(layers, tr)
    trainer = Trainer(net, x, y, xt, yt, device=device)
    return net, trainer, tr


def run(cell_name, seed, seconds, trace, device="cuda", t_start=None,
        log=sys.stderr):
    """Run ``cell_name`` once; returns the result line as a dict. The
    result's ``device`` names the device it ran on; on a CPU device the
    run is a rehearsal and its times say nothing of a chip."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = cells.benchmark()
    cell = cells.cell(cell_name)
    cfg = cells.config(cell["config"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    data = make_data(cfg, seed)
    x, y, xt, yt = data
    data_s = time.perf_counter() - t0

    build_s = 0.0
    if on_card:
        from theanet_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.build()
        build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    net, trainer, tr = build_trainer(cfg, cell, seed, data, dev)
    trainer_s = time.perf_counter() - t0
    desc = net_from_layers(cells.layers(cfg), tr["BATCH_SZ"], x.shape[3],
                           x.shape[1])
    ckpt_dir = tempfile.mkdtemp(prefix="portbench_ckpt_")
    from .loop import Loop

    loop = Loop(trainer, tr, ckpt_dir,
                "{}_{:06d}".format(cfg["name"], tr["SEED"]),
                sync_boundary=trace and on_card)
    try:
        t0 = time.perf_counter()
        r0 = loop.round()
        first_s = time.perf_counter() - t0
        prog = dict(losses=r0.costs[0].copy(),
                    state=to_leaves(trainer.params, desc, dev),
                    moms=to_leaves(trainer.moms, desc, dev))
        first = dict(r0.boundary, state=prog["state"])
        if on_card:
            torch.cuda.synchronize()
        t_win = time.perf_counter()
        setup_s = t_win - t_start

        rounds, profiled, prof, p_wall = [], [], None, (0.0, 0.0)
        n_trace = int(cell.get("trace_periods", 3)) if trace else 0
        while True:
            elapsed = time.perf_counter() - t_win
            if (prof is None and len(profiled) < n_trace
                    and elapsed >= seconds / 2):
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if on_card else [])
                prof = profile(activities=acts)
                prof.__enter__()
                p_wall = (time.perf_counter(), 0.0)
            rounds.append(loop.round())
            if prof is not None:
                profiled.append(len(rounds) - 1)
                if len(profiled) == n_trace:
                    if on_card:
                        torch.cuda.synchronize()
                    p_wall = (p_wall[0], time.perf_counter())
                    prof.__exit__(None, None, None)
                    prof_done, prof = prof, None
            if (time.perf_counter() - t_win >= seconds
                    and len(profiled) == n_trace and prof is None):
                break
        window_s = rounds[-1].end - t_win
        start = to_leaves(trainer.params, desc, dev)
        moms = to_leaves(trainer.moms, desc, dev)
        last = dict(rounds[-1].boundary, state=start)
        e_after = r0.epochs + sum(r.epochs for r in rounds)
        r_after = loop.round()
        prog_after = dict(losses=r_after.costs[0].copy(),
                          state=to_leaves(trainer.params, desc, dev))
        after = dict(r_after.boundary, state=prog_after["state"])
        peak = (int(torch.cuda.max_memory_allocated(dev)) if on_card
                else 0)
        kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    finally:
        loop.close()
        os.rmdir(ckpt_dir)
    del loop, trainer, net
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    ctx = Ctx(net=desc, peaks=cells.peaks(kind if on_card else "NVIDIA H100"),
              kernel_map=cells.kernel_map(cell["config"]), setup_s=setup_s,
              window_s=window_s, rounds=rounds, profiled=profiled)
    breakdown, busy = None, 0.0
    if trace:
        events = prof_done.events()
        ctx.dev_spans, ctx.host_ranges = trace_mod.split_events(events)
        rs = ctx.profiled_rounds()
        starts = [a for name, a, _ in ctx.host_ranges if name == "epochs"]
        ctx.t0_us = min(starts) if starts else 0.0
        ctx.wall_us = (p_wall[1] - p_wall[0]) * 1e6
        del prof_done, events
        gc.collect()
        busy = trace_mod.union_us(ctx.dev_spans) * 1e-6
        breakdown = {
            "device_ops": [[k, v * 1e-6] for k, v in
                           trace_mod.top_ops(ctx.dev_spans)],
            "idle_gaps": [[k, v * 1e-6] for k, v in trace_mod.idle_gaps(
                ctx.dev_spans, ctx.host_ranges, ctx.t0_us,
                ctx.t0_us + ctx.wall_us)]}
        print(f"portbench: traced {len(rs)} periods, "
              f"{sum(r.steps for r in rs)} steps, "
              f"{len(ctx.dev_spans)} device spans", file=log)

    # the comparison, after the window and with the program freed
    t_ref = time.perf_counter()
    rows = compare.step_rows(desc, x, y, dev)
    ref = compare.first_epoch(desc, cells.layers(cfg), tr, tr["SEED"], rows)
    ref_after = compare.follow(desc, tr, tr["SEED"], e_after, start, moms,
                               rows, n_epochs=r_after.epochs)
    dd = {"test": (torch.as_tensor(xt, device=dev),
                   torch.as_tensor(yt, device=dev)),
          "train": (torch.as_tensor(x, device=dev),
                    torch.as_tensor(y, device=dev))}
    values, where = compare.readings(desc, ref, prog, ref_after, prog_after,
                                     [first, last, after], dd)
    checked, correct = compare.checks(values, cell["limits"])
    ref_s = time.perf_counter() - t_ref
    del ref, ref_after, rows, dd

    names = cells.metric_names(bench, trace)
    metrics = {}
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    for name in names:
        v = cells.reader(name)(ctx)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": units[name]}

    periods = [r.period_s * 1e3 / r.epochs for r in rounds]
    print(f"portbench: {cell_name} seed {seed}: set-up {setup_s:.3f} s "
          f"(data {data_s:.3f} s, kernel build {build_s:.3f} s, Trainer "
          f"{trainer_s:.3f} s, first round {first_s:.3f} s), window "
          f"{window_s:.3f} s, "
          f"{len(rounds)} test periods ({sum(r.epochs for r in rounds)} "
          f"epochs), epoch ms median {statistics.median(periods):.3f}, "
          f"checkpoints written "
          f"{sum(r.ckpt_bytes for r in [r0] + rounds + [r_after])} bytes, "
          f"the epoch after the window {e_after}, reference {ref_s:.3f} s",
          file=log)
    print(f"portbench: not compared: worst leaf's change gap "
          f"{values['change_worst']!r} ({where['change_worst']}), momenta "
          f"{values['mom_gap']!r} ({where['mom_gap']}); leaves left out: "
          f"{where['left_out'] or 'none'}", file=log)
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": int(cell.get("chips", 1)) if on_card else 1,
                   "memory_peak_bytes": peak}
    if trace:
        device_info["busy_s"] = busy
        device_info["window_s"] = ctx.wall_us * 1e-6
    out = {"correct": bool(correct),
           "attempted": sum(r.epochs for r in rounds),
           "failed": 0, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, v, lim in checked}
    return out

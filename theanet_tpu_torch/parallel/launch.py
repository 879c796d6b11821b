"""Start the ranks of a data-parallel run, and the training target they run.

``launch(fn, n, backend, init_file, *args)`` spawns ``n`` processes (the
``spawn`` start method: each imports only what ``fn`` needs, never the
caller's test modules), joins each to one process group through a
``file://`` rendezvous at ``init_file`` and calls ``fn(rank, n, *args)``.
It raises when any rank fails, after stopping the others. ``fn`` must be
importable by name: ``train_ranks`` below is the target the tests and
``chip_smoke.py`` use.

    from theanet_tpu_torch.parallel import launch
    launch(train_ranks, 2, "gloo", "/tmp/rdzv", job_file, out_dir)
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import time

__all__ = ["launch", "train_ranks"]


def _rank_main(fn, rank, n, backend, init_file, args):
    import torch.distributed as dist

    dist.init_process_group(backend, init_method="file://" + init_file,
                            world_size=n, rank=rank)
    try:
        fn(rank, n, *args)
    finally:
        dist.destroy_process_group()


def launch(fn, n, backend, init_file, *args, timeout=1800):
    """Run ``fn(rank, n, *args)`` in ``n`` spawned ranks of one ``backend``
    process group; ``init_file`` must not exist yet (the rendezvous creates
    it). Raises RuntimeError naming the ranks that failed or outlived
    ``timeout`` seconds; every rank has ended when it returns."""
    if os.path.exists(init_file):
        raise ValueError(f"the rendezvous file {init_file} exists already")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, backend, init_file, args))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.exitcode is None for p in procs):
            if (any(p.exitcode not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            for p in procs:
                p.join(0.1)
    finally:
        for p in procs:   # a failed rank leaves the others in a collective
            if p.is_alive():
                p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(
            f"data-parallel ranks failed (rank, exit code): {bad}; a "
            "negative code is a rank stopped after the first failure or at "
            f"the {timeout} s limit")


def train_ranks(rank, n, job_file, out_dir):
    """The launch target of a data-parallel training run: for each config of
    the pickled job (``name``, ``layers``, ``training_params``, ``data`` the
    four arrays training_x, training_y, testing_x, testing_y, and for a net
    with an aux layer training_aux, testing_aux, ``epochs``,
    optional ``profile``, ``dp_ring`` and ``ring_rs``: the THEANET_DP_RING
    and THEANET_RING_RS of the run, default 'auto'), build the net and
    ``Trainer(..., mesh=make_mesh(n))``, train ``epochs`` epochs and pickle
    to ``out_dir/<name>_rank<rank>.pkl``: the per-epoch costs and minf, each
    epoch's ms (CUDA events on a card, the host clock on the CPU), the
    launches of the data-parallel kernels (the per-step path's gradient and
    update, the ring epochs and their exchanges), whether the ring ran, the
    final state in framework layout, the test evaluation and whether
    ``save_checkpoint`` wrote ``out_dir/<name>.pkl``. With ``profile`` one
    more epoch runs under torch.profiler for the device's idle share. The
    Trainer is closed (the ring's buffers freed) before the next config."""
    import numpy as np
    import torch

    from ..model import NeuralNet
    from ..ops import megastep, megastep_deep, megastep_ring
    from ..prms import fixdim
    from ..trainer import Trainer
    from .mesh import make_mesh

    with open(job_file, "rb") as f:
        job = pickle.load(f)
    counters = (megastep.megastep_grad_step, megastep.megastep_update,
                megastep_deep.deep_grad_step, megastep_deep.deep_update,
                megastep_ring.megastep_ring_epoch,
                megastep_ring.deep_ring_epoch, megastep_ring.ring_exchange)
    for cfg in job:
        # the job, not the launching process's environment, sets the path
        os.environ["THEANET_DP_RING"] = cfg.get("dp_ring", "auto")
        os.environ["THEANET_RING_RS"] = cfg.get("ring_rs", "auto")
        tx, ty, vx, vy, *aux = cfg["data"]
        tx, vx = fixdim(tx), fixdim(vx)
        layers = [[name, dict(a)] for name, a in cfg["layers"]]
        layers[0][1]["img_sz"] = tx.shape[3]
        if "num_maps" not in layers[0][1] and tx.shape[1] != 1:
            layers[0][1]["num_maps"] = tx.shape[1]
        net = NeuralNet(layers, dict(cfg["training_params"]))
        trainer = Trainer(net, tx, ty, vx, vy, mesh=make_mesh(n),
                          train_aux=aux[0] if aux else None,
                          test_aux=aux[1] if aux else None)
        cuda = trainer.device.type == "cuda"
        out = {"costs": [], "minf": [], "ms": [],
               "ring": bool(getattr(trainer._mega_epoch, "ring", False))}
        for fn in counters:
            fn.launches = 0
        for _ in range(cfg["epochs"]):
            if cuda:
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record()
            else:
                t = time.perf_counter()
            _, costs, minf = trainer.run_epoch()
            if cuda:
                t1.record()
                torch.cuda.synchronize()
                out["ms"].append(t0.elapsed_time(t1))
            else:
                out["ms"].append((time.perf_counter() - t) * 1e3)
            out["costs"].append(costs)
            out["minf"].append(minf)
            net.inc_epoch_set_rate()
        out["launches"] = {fn.__name__: fn.launches for fn in counters}
        trainer.sync_net()
        out["params"] = [[np.asarray(w.detach().cpu()) for w in lw]
                         for lw in trainer.params]
        out["test"] = trainer.evaluate_full("test")
        out["wrote_checkpoint"] = trainer.save_checkpoint(
            os.path.join(out_dir, cfg["name"] + ".pkl"))
        if cfg.get("profile") and cuda:
            out["idle_share"] = _idle_share(trainer)
        trainer.close()
        with open(os.path.join(out_dir, f"{cfg['name']}_rank{rank}.pkl"),
                  "wb") as f:
            pickle.dump(out, f)


def _idle_share(trainer):
    """1 - the device's busy time over the wall time of one more epoch under
    torch.profiler (this process's kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.run_epoch()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    busy = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            busy += e.self_cuda_time_total if t is None else t
    return 1.0 - busy / wall_us

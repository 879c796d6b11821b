"""The port's probe tools (``python -m theanet_tpu_torch.tools.<name>``):
``floor_probe`` and ``conv_layout_probe``, the Hopper counterparts of the
JAX package's ``tools/floor_probe.py`` and ``tools/conv_layout_probe.py``.
Each runs on the card unless given ``--device cpu`` (the plain versions,
which measure nothing of the card)."""

from __future__ import annotations

import subprocess

import torch

__all__ = ["card", "probe_device", "event_ms"]


def probe_device(name):
    """The device of a probe run: ``name`` ('cuda' or 'cpu'). Asking for
    CUDA where there is no card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device; pass --device cpu to "
                           "run the plain versions on the CPU")
    return dev


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, chain, reps):
    """Best of ``reps`` CUDA-event timings of ``chain`` calls of ``fn``, in
    ms a call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(chain):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / chain)
    return best

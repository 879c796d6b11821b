"""The per-step floor of a fused epoch on the card.

Port of the JAX package's ``tools/floor_probe.py`` (its Pallas probe
``make_probe``). Trivial kernels that differ only in their per-step input
streams: for each step every input block is staged whole into shared
memory, the traffic the TPU grid's DMA carries, and one output row of the
blocks' f32 sum is stored (``csrc/probes.cu`` ``k_floor``). The variants
are the JAX tool's:

  mirror   the flagship's 6 input blocks: x f32 (20, 784), y (20, 1),
           ub (1, 8), fb (784, 4), pb (20, 784), db (20, 500)
  widefb   the same, fb as (4, 784)
  packed   x and ONE (48, 784) word block
  xonly    x alone
  tiny     one (8, 128) f32 block

Words are int32 (the port holds the noise words so) and are summed as
integers. With ``--grid-u`` U > 1 a block of the kernel holds U steps and
sums each step's blocks' first rows, as the JAX kernel does with its (U,)
blocks. ``--launch epoch`` runs the epoch as one launch (the counterpart of
the TPU's grid); ``--launch step`` as one launch a U steps: the card's own
per-launch floor, beside the ~13 stage launches of a flagship step.

    python -m theanet_tpu_torch.tools.floor_probe [--batches 3000]
        [--chain 5] [--reps 3] [--variants mirror,...] [--out vmem|smem]
        [--grid-u U] [--launch epoch|step] [--device cuda|cpu]

On the card the time is taken by CUDA events and printed as us/step beside
the card's name and power limit; ``--device cpu`` runs the plain version,
whose time says nothing of the card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import card, event_ms, probe_device

__all__ = ["VARIANTS", "variant_inputs", "floor_reference", "floor_probe",
           "main"]

F32, I32 = "f32", "i32"
# per-step block shapes and types of each variant (floor_probe.py:133-141)
VARIANTS = {
    "mirror": [((20, 784), F32), ((20, 1), I32), ((1, 8), I32),
               ((784, 4), I32), ((20, 784), I32), ((20, 500), I32)],
    "widefb": [((20, 784), F32), ((20, 1), I32), ((1, 8), I32),
               ((4, 784), I32), ((20, 784), I32), ((20, 500), I32)],
    "packed": [((20, 784), F32), ((48, 784), I32)],
    "xonly": [((20, 784), F32)],
    "tiny": [((8, 128), F32)],
}
OUT_WIDTH = {"vmem": 128, "smem": 2}


def variant_inputs(name, n_steps, device, rng=None):
    """The variant's (n_steps, *shape) inputs as the JAX tool draws them:
    f32 blocks uniform on k/256, word blocks integers in [0, 2^16)."""
    rng = np.random.RandomState(0) if rng is None else rng
    out = []
    for shape, kind in VARIANTS[name]:
        if kind == F32:
            a = rng.randint(0, 255, (n_steps,) + shape).astype(np.float32) \
                / 256.0
        else:
            a = rng.randint(0, 1 << 16, (n_steps,) + shape).astype(np.int32)
        out.append(torch.as_tensor(a, device=device))
    return out


def floor_reference(inputs, width, grid_u=1):
    """The plain version: (n_steps, width) rows of each step's sum. A block
    is summed exactly (float64, int64 for words) and rounded to f32 once;
    the blocks' sums add in f32 in stream order. With ``grid_u`` > 1 each
    block's first row is summed."""
    n = inputs[0].shape[0]
    acc = torch.zeros(n, dtype=torch.float32, device=inputs[0].device)
    for t in inputs:
        blk = (t if grid_u == 1 else t[:, 0]).reshape(n, -1)
        wide = torch.int64 if t.dtype == torch.int32 else torch.float64
        s = blk.to(wide).sum(1).to(torch.float64).to(torch.float32)
        acc = acc + s
    return acc[:, None].expand(n, width).contiguous()


def floor_probe(inputs, width, grid_u=1, per_launch=False):
    """The floor kernel over the inputs, or on CPU tensors its plain
    version; counts kernel launches in ``floor_probe.launches``."""
    dev = inputs[0].device
    if dev.type == "cpu":
        return floor_reference(inputs, width, grid_u)
    if dev.type != "cuda":
        raise ValueError(f"floor_probe: no kernel for {dev}")
    n = inputs[0].shape[0]
    if n % grid_u:
        raise ValueError(f"{n} steps do not divide into blocks of {grid_u}")
    for t in inputs:
        if (t.device != dev or not t.is_contiguous() or t.shape[0] != n
                or t.dtype not in (torch.float32, torch.int32)):
            raise ValueError("floor_probe: inputs must be contiguous f32 or "
                             "int32 tensors of one device and step count")
    from ..ops import _build

    out = torch.empty((n, width), dtype=torch.float32, device=dev)
    floor_probe.launches += _build.floor_probe_launch(inputs, out, grid_u,
                                                      per_launch)
    return out


floor_probe.launches = 0


def main(argv=None):
    """Run the probe; returns {variant: ms an epoch} (empty on the CPU)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=3000)
    ap.add_argument("--chain", type=int, default=5,
                    help="epochs timed between two CUDA events")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default="mirror,widefb,packed,xonly,tiny")
    ap.add_argument("--out", default="vmem", choices=sorted(OUT_WIDTH),
                    help="row width a step: vmem 128 copies, smem 2")
    ap.add_argument("--grid-u", type=int, default=1,
                    help="steps a block of the kernel holds (U)")
    ap.add_argument("--launch", default="epoch", choices=["epoch", "step"],
                    help="one launch an epoch, or one a block of U steps")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = probe_device(args.device)
    nb, width = args.batches, OUT_WIDTH[args.out]
    print(card() if dev.type == "cuda" else
          "device cpu: the plain version (no card time)", flush=True)
    rng = np.random.RandomState(0)
    times = {}
    for name in args.variants.split(","):
        ins = variant_inputs(name, nb, dev, rng)
        bytes_step = sum(int(np.prod(s)) * 4 for s, _ in VARIANTS[name])

        def run():
            return floor_probe(ins, width, args.grid_u,
                               args.launch == "step")

        if dev.type == "cpu":
            out = run()
            print(f"{name:8s} streams={len(ins)} bytes/step={bytes_step:7d} "
                  f"row0={float(out[0, 0]):.1f} (plain version)", flush=True)
            continue
        ms = times[name] = event_ms(run, args.chain, args.reps)
        print(f"{name:8s} streams={len(ins)} bytes/step={bytes_step:7d} "
              f"us/step={ms * 1e3 / nb:8.3f}  (epoch {ms:.3f} ms, "
              f"{nb * 20 / ms * 1e3:,.0f} img/s; U={args.grid_u}, "
              f"launch={args.launch}, out={args.out})", flush=True)
    return times


if __name__ == "__main__":
    main()

"""The flagship's conv2 section on the card, in two card layouts.

Port of the JAX package's ``tools/conv_layout_probe.py`` (its Pallas probes
``make_section`` and ``make_relay``). The section is the flagship's conv2
forward and backward at its shapes (M1 4, M2 20, B 20, a 13x13 plane,
3x3 taps, pool 2) on an input made in the kernel from the step's streamed
(8, 128) block: p1(m1, b, q) = (q mod 31) * s, s = sum(block) * 1e-6. Taps
read circularly over the 169 positions, as the TPU's lane rolls do. Per
step: the forward pass, leaky .05, the valid mask, the 2x2 max pool and its
compaction p2, the pool backward (dp2 = p2 / 1000 reaches the positions
equal to their window's max), the weight gradient dw and the input gradient
dpp; the output is sum(dw) + sum(dpp[0]) + sum(p2[0]), the JAX 'striped'
variant's function, and beside it sum(dpp), a check over the whole input
gradient. The JAX tool's 'grouped' variants are TPU lane-slot layouts of
the same function and are not ported (ROADMAP.md says why); the card's
layouts are

  block    a block a step: one sample's planes at a time in shared memory
           (one launch an epoch, or one a step with --launch step)
  thread   a thread per output over device-memory planes, 7 launches a
           step (the fused kernels' stage form)

and the relay, the grouped design's entrance copy alone:

  relay5x4, relay10x2   the (20, 784) batch copied into G-row blocks of g
                        shared-memory slots of 896 floats, read back summed

    python -m theanet_tpu_torch.tools.conv_layout_probe [--batches 3000]
        [--chain 5] [--reps 3] [--variants block,thread,relay5x4,relay10x2]
        [--launch epoch|step] [--device cuda|cpu]

Kernels: ``csrc/probes.cu`` (``k_sec_block``, the ``k_sec_*`` stages,
``k_relay``). On the card the time is taken by CUDA events and printed as
us/step beside the card's name and power limit; ``--device cpu`` runs the
plain versions.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import card, event_ms, probe_device

__all__ = ["M1", "M2", "B", "P1", "F", "section_inputs", "relay_inputs",
           "section_reference", "conv_section", "relay_reference",
           "relay_probe", "main"]

M1, M2, B = 4, 20, 20
P1, F, POOL = 13, 3, 2
PQ = P1 * P1
C2 = P1 - F + 1
P2 = -(-C2 // POOL)
HW = 784
SECTION_VARIANTS = {"block": 0, "thread": 1}


def section_inputs(n_steps, device):
    """(x (n, 8, 128), w2 (M2, 9*M1), b2 (M2,)) as the JAX tool draws them
    (RandomState(7): w2, b2, then the streamed blocks)."""
    rng = np.random.RandomState(7)
    w2 = rng.randn(M2, F * F * M1).astype(np.float32) * 0.1
    b2 = rng.randn(M2, 1).astype(np.float32) * 0.1
    x = rng.rand(n_steps, 8, 128).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (x, w2, b2.reshape(M2)))


def relay_inputs(n_steps, device):
    """The (n, 20, 784) batches as the JAX tool draws them."""
    rng = np.random.RandomState(3)
    return torch.as_tensor(rng.rand(n_steps, B, HW).astype(np.float32),
                           device=device)


def _tap_offsets():
    return [(F - 1 - u) * P1 + (F - 1 - v) for u in range(F)
            for v in range(F)]


def _section_chunk(x, w2, b2):
    n, dev = x.shape[0], x.device
    q = torch.arange(PQ, device=dev)
    s = x.reshape(n, -1).double().sum(1).float() * 1e-6
    p1 = (q % 31).float()[None, :] * s[:, None]            # (n, PQ)
    p1 = p1[:, None, None, :].expand(n, M1, B, PQ)          # (n, m1, b, q)
    offs = _tap_offsets()
    stk = torch.stack([torch.roll(p1, -o, dims=-1) for o in offs], 1)
    w = w2.reshape(M2, F * F, M1)
    z = (torch.einsum("mkc,nkcbq->nmbq", w, stk)
         + b2[None, :, None, None])                       # (n, m2, b, q)
    h = torch.clamp(z, min=0) + 0.05 * torch.clamp(z, max=0)
    yy, xx = q // P1, q % P1
    valid = (yy < C2) & (xx < C2)
    zm = torch.where(valid, h, torch.full_like(h, -1e30))
    row = torch.maximum(zm, torch.roll(zm, -1, dims=-1))
    mx = torch.maximum(row, torch.roll(row, -P1, dims=-1))
    ii, jj = torch.meshgrid(torch.arange(P2, device=dev),
                            torch.arange(P2, device=dev), indexing="ij")
    anchors = ((POOL * ii) * P1 + POOL * jj).reshape(-1)
    p2 = mx[..., anchors]                                  # (n, m2, b, 36)
    dp2 = p2 * 0.001
    win = ((yy // POOL) * P2 + xx // POOL).clamp(max=P2 * P2 - 1)
    dmxe = torch.where(valid, dp2[..., win], torch.zeros_like(zm))
    xm, ym = (q % P1) % POOL, (q // P1) % POOL
    t1 = torch.where(xm == 1, torch.roll(mx, 1, dims=-1), mx)
    mxe = torch.where(ym == 1, torch.roll(t1, P1, dims=-1), t1)
    dz = torch.where(zm == mxe, dmxe, torch.zeros_like(zm))
    dz = dz * torch.where(z > 0, 1.0, 0.05)
    dw = torch.einsum("nmbq,nkcbq->nmkc", dz, stk)         # (n, m2, k, m1)
    dstack = torch.einsum("mkc,nmbq->nkcbq", w, dz)
    dpp = sum(torch.roll(dstack[:, t], o, dims=-1)
              for t, o in enumerate(offs))                 # (n, m1, b, q)
    acc = (dw.reshape(n, -1).sum(1) + dpp[:, 0, 0].sum(1)
           + p2[:, 0, 0].sum(1))
    return torch.stack([acc, dpp.reshape(n, -1).sum(1)], 1)


def section_reference(x, w2, b2, chunk=256):
    """The plain version of the section: (n, 2), each step's sum(dw) +
    sum(dpp[0]) + sum(p2[0]) and sum(dpp), on the striped rows (m, b)."""
    return torch.cat([_section_chunk(x[i:i + chunk], w2, b2)
                      for i in range(0, x.shape[0], chunk)])


def conv_section(x, w2, b2, variant="block", per_launch=False):
    """The section kernel in the layout ``variant`` ('block', 'thread'), or
    on CPU tensors its plain version; counts kernel launches in
    ``conv_section.launches``."""
    if x.device.type == "cpu":
        return section_reference(x, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"conv_section: no kernel for {x.device}")
    if (x.dim() != 3 or x.shape[1:] != (8, 128)
            or w2.shape != (M2, F * F * M1) or b2.shape != (M2,)
            or any(t.device != x.device or t.dtype != torch.float32
                   or not t.is_contiguous() for t in (x, w2, b2))):
        raise ValueError("conv_section: x (n, 8, 128), w2 (20, 36), b2 "
                         "(20,), contiguous f32 on one device")
    from ..ops import _build

    out = torch.empty((x.shape[0], 2), dtype=torch.float32, device=x.device)
    conv_section.launches += _build.conv_section_launch(
        x, w2, b2, out, SECTION_VARIANTS[variant], per_launch)
    return out


conv_section.launches = 0


def relay_reference(x, G, g):
    """The plain version of the relay: each step's sum, slot by slot (a
    slot summed exactly and rounded to f32, the slots added in f32)."""
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for j in range(g):
        acc = acc + x[:, j * G:(j + 1) * G].double().sum((1, 2)).float()
    return acc


def relay_probe(x, G, g, per_launch=False):
    """The relay kernel at G x g, or on CPU tensors its plain version;
    counts kernel launches in ``relay_probe.launches``."""
    if G * g != B:
        raise ValueError(f"G x g must be the batch of {B}")
    if x.device.type == "cpu":
        return relay_reference(x, G, g)
    if x.device.type != "cuda":
        raise ValueError(f"relay_probe: no kernel for {x.device}")
    if (x.dim() != 3 or x.shape[1:] != (B, HW) or x.dtype != torch.float32
            or not x.is_contiguous()):
        raise ValueError("relay_probe: x (n, 20, 784), contiguous f32")
    from ..ops import _build

    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    relay_probe.launches += _build.relay_probe_launch(x, G, g, out,
                                                      per_launch)
    return out


relay_probe.launches = 0


def main(argv=None):
    """Run the probes; returns {variant: ms an epoch} (empty on the
    CPU)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=3000)
    ap.add_argument("--chain", type=int, default=5,
                    help="epochs timed between two CUDA events")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default="block,thread,relay5x4,relay10x2")
    ap.add_argument("--launch", default="epoch", choices=["epoch", "step"],
                    help="block and relay: one launch an epoch or a step")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = probe_device(args.device)
    nb, per_launch = args.batches, args.launch == "step"
    print(card() if dev.type == "cuda" else
          "device cpu: the plain versions (no card time)", flush=True)
    times = {}
    for name in args.variants.split(","):
        if name.startswith("relay"):
            G, g = (int(v) for v in name[len("relay"):].split("x"))
            x = relay_inputs(nb, dev)

            def run():
                return relay_probe(x, G, g, per_launch)
        elif name in SECTION_VARIANTS:
            x, w2, b2 = section_inputs(nb, dev)

            def run():
                return conv_section(x, w2, b2, name, per_launch)
        else:
            raise SystemExit(
                f"variant {name!r}: the card's layouts are "
                f"{', '.join(SECTION_VARIANTS)}, relay<G>x<g>; 'striped' "
                "and 'grouped*' are TPU lane-slot layouts (ROADMAP.md)")
        if dev.type == "cpu":
            first = float(run().reshape(nb, -1)[0, 0])
            print(f"{name:10s} step 0: {first:.6g} (plain version)",
                  flush=True)
            continue
        ms = times[name] = event_ms(run, args.chain, args.reps)
        print(f"{name:10s} {ms * 1e3 / nb:8.3f} us/step  (epoch {ms:.3f} ms, "
              f"launch={args.launch})", flush=True)
    return times


if __name__ == "__main__":
    main()

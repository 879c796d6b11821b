"""Resample a batch at one warp, with invert and pixel flip, in one call.

Port of ``theanet_tpu/ops/elastic_pallas.py::_kernel`` (the ElasticLayer's
``'method': 'pallas'``). The TPU kernel builds an (hw, hw) one-hot tap
matrix and multiplies by it, a workaround for Mosaic's missing gather; on
the card it is a gather (``csrc/elastic_resample.cu``): one thread per
output element reads its 1 (nearest) or 4 (bilinear) taps at the shared
warp (ty[p], tx[p]), inverts each tap where asked, and flips the result
where its word says so. With no (hw, hw) matrix it takes any image size.

  * ``elastic_resample_reference`` is the plain PyTorch version: the
    specification the kernel is held to, and what CPU tensors run.
  * ``elastic_resample`` is the wrapper: CPU tensors run the plain version,
    CUDA tensors launch the kernel (counted in
    ``elastic_resample.launches``), any other device raises.

Rounding is part of the contract: the resampled pixels feed a conv and a
max pool whose gradient reaches every exact tie, so the kernel rounds each
operation separately in the plain version's order (no FMA contraction).
Nearest is floor(t + .5), an exact copy.
"""

from __future__ import annotations

import torch

__all__ = ["elastic_resample_reference", "elastic_resample"]


def elastic_resample_reference(x, ty, tx, words, *, nearest, pflip=0.0,
                               invert=False):
    """x (B, C, H, W) f32 resampled at the clipped warp ty, tx (H, W):
    invert each tap (1 - v) where ``invert``, take floor(t + .5) (nearest)
    or the 4 bilinear taps, then flip v -> 1 - v where the element's word
    of ``words`` (int32, x's shape; None without pflip), as a uniform from
    its low 24 bits, is below ``pflip``."""
    b, c, h, w = x.shape
    src = (1.0 - x if invert else x).reshape(b, c, h * w)
    if nearest:
        idx = (torch.floor(ty + 0.5).long() * w
               + torch.floor(tx + 0.5).long()).reshape(-1)
        out = src[:, :, idx]
    else:
        top, left = ty.long(), tx.long()    # trunc == floor here
        fy = (ty - top.to(torch.float32)).reshape(-1)
        fx = (tx - left.to(torch.float32)).reshape(-1)
        i00 = (top * w + left).reshape(-1)
        out = (src[:, :, i00] * ((1.0 - fy) * (1.0 - fx))
               + src[:, :, i00 + 1] * ((1.0 - fy) * fx)
               + src[:, :, i00 + w] * (fy * (1.0 - fx))
               + src[:, :, i00 + w + 1] * (fy * fx))
    out = out.reshape(b, c, h, w)
    if pflip:
        u = (words & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
        out = torch.where(u < pflip, 1.0 - out, out)
    return out


def _check(x, ty, tx, words, pflip):
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"elastic_resample: x must be (B, C, H, W) f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    hw = tuple(x.shape[2:])
    want = [(ty, hw, torch.float32), (tx, hw, torch.float32)]
    if pflip:
        if words is None:
            raise ValueError("elastic_resample: pflip needs words")
        want.append((words, tuple(x.shape), torch.int32))
    for t, shape, dtype in [(x, tuple(x.shape), torch.float32)] + want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"elastic_resample: got {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("elastic_resample: tensors must be contiguous "
                             f"and on {x.device}")


def elastic_resample(x, ty, tx, words, *, nearest, pflip=0.0, invert=False):
    """Same contract as elastic_resample_reference. A CPU ``x`` runs the
    plain version; a CUDA ``x`` launches the CUDA kernel on the current
    stream and counts it in ``elastic_resample.launches``; any other device
    raises."""
    if x.device.type == "cpu":
        return elastic_resample_reference(x, ty, tx, words, nearest=nearest,
                                          pflip=pflip, invert=invert)
    if x.device.type != "cuda":
        raise ValueError(f"elastic_resample: no kernel for {x.device}")
    _check(x, ty, tx, words, pflip)
    from . import _build

    out = torch.empty_like(x)
    _build.elastic_resample_launch(x, ty, tx, words if pflip else None, out,
                                   bool(nearest), float(pflip), bool(invert))
    elastic_resample.launches += 1
    return out


elastic_resample.launches = 0

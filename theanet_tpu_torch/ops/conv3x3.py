"""3x3 stride-1 valid convolution with a hand-written forward and backward.

Port of ``theanet_tpu/ops/conv_pallas.py``: ``_fwd_kernel`` and
``_bwd_kernel`` become the forward and backward of ``csrc/conv3x3.cu``,
and ``jax.custom_vjp`` becomes ``torch.autograd.Function``. The function
is a CORRELATION (the caller flips the filter for a true convolution):
x (B, C, H, H), w (M, C, 3, 3) -> (B, M, H-2, H-2), in f32 or bf16 with
f32 accumulation.

  * ``eligible`` is the JAX package's predicate, unchanged, so the same
    environment routes the same convs in both packages.
  * ``conv3x3_forward_reference`` / ``conv3x3_backward_reference`` are the
    plain PyTorch versions: the specification the kernels are held to, and
    what CPU tensors run. They sum tap by tap in the JAX kernel's order
    (taps outer, k = dy*3 + dx, each a K = C or K = M product) in f32.
  * ``conv3x3_forward`` / ``conv3x3_backward`` are the wrappers: CPU
    tensors run the plain version, CUDA tensors launch the kernel (counted
    in ``conv3x3_forward.launches`` and ``conv3x3_backward.launches``), any
    other device raises.
  * ``conv3x3_valid`` is the differentiable function.

The TPU kernel's lane roll, padded H*W lane grid, crop, valid mask and
VMEM batch accumulator are Mosaic workarounds: the kernels here compute
the valid outputs directly, and sum dw over the batch in a fixed order.
"""

from __future__ import annotations

import torch

__all__ = ["eligible", "conv3x3_forward_reference",
           "conv3x3_backward_reference", "conv3x3_forward",
           "conv3x3_backward", "conv3x3_valid"]

F = 3  # filter side this kernel specializes
# dw is summed over the batch in at most this many slices, each a block
# column of the kernel's grid, then over the slices in order
DW_SPLITS = 64
_DTYPES = (torch.float32, torch.bfloat16)


def eligible(x_shape, w_shape, mode, stride):
    """Shapes the kernel takes (conv_pallas.py:41-51): 3x3, stride 1,
    valid, square, C % 8 == 0, C >= 16, M % 8 == 0."""
    B, C, H, W = x_shape
    M, C2, fh, fw = w_shape
    return (
        mode == "valid" and stride == 1
        and fh == F and fw == F and C2 == C and H == W
        and C % 8 == 0 and C >= 16 and M % 8 == 0
        and H >= F
    )


# the taps in the kernel's order, k = dy * 3 + dx
_TAPS = [(dy, dx) for dy in range(F) for dx in range(F)]


def conv3x3_forward_reference(x, w):
    """z (B, M, H-2, H-2) in x's dtype: for each tap in order, z += the
    K = C product w[:, :, dy, dx] . x[:, :, dy:dy+O, dx:dx+O], in f32."""
    O = x.shape[2] - F + 1
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    z = None
    for dy, dx in _TAPS:
        t = torch.einsum("mc,bcyx->bmyx", wf[:, :, dy, dx],
                         xf[:, :, dy:dy + O, dx:dx + O])
        z = t if z is None else z + t
    return z.to(x.dtype)


def conv3x3_backward_reference(x, w, dz):
    """(dx, dw) of conv3x3_forward_reference for dz (B, M, O, O): dx in
    x's dtype, the full correlation of dz with the flipped taps summed tap
    by tap (K = M each) in f32; dw (M, C, 3, 3) summed over the whole batch
    in f32, then cast to w's dtype (conv_pallas.py:229-244)."""
    O = x.shape[2] - F + 1
    xf, wf, dzf = x.to(torch.float32), w.to(torch.float32), dz.to(
        torch.float32)
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dw = torch.empty(w.shape, dtype=torch.float32, device=x.device)
    for dy, dxo in _TAPS:
        dx[:, :, dy:dy + O, dxo:dxo + O] += torch.einsum(
            "mc,bmyx->bcyx", wf[:, :, dy, dxo], dzf)
        dw[:, :, dy, dxo] = torch.einsum(
            "bmyx,bcyx->mc", dzf, xf[:, :, dy:dy + O, dxo:dxo + O])
    return dx.to(x.dtype), dw.to(w.dtype)


def _check(name, x, w, dz=None):
    """Raise unless x (B, C, H, H), w (M, C, 3, 3) and dz (B, M, O, O)
    share one dtype the kernel takes, one device, and are contiguous."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{name}: x and w must be 4-d, got {tuple(x.shape)}"
                         f" and {tuple(w.shape)}")
    B, C, H, W = x.shape
    M = w.shape[0]
    if (H != W or H < F or tuple(w.shape) != (M, C, F, F)
            or x.dtype not in _DTYPES or w.dtype != x.dtype):
        raise ValueError(f"{name}: need x (B, C, H, H) and w (M, C, 3, 3) "
                         f"of one dtype in {_DTYPES}, got {tuple(x.shape)} "
                         f"{x.dtype} and {tuple(w.shape)} {w.dtype}")
    tensors = [x, w]
    if dz is not None:
        want = (B, M, H - F + 1, H - F + 1)
        if tuple(dz.shape) != want or dz.dtype != x.dtype:
            raise ValueError(f"{name}: dz must be {want} {x.dtype}, got "
                             f"{tuple(dz.shape)} {dz.dtype}")
        tensors.append(dz)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {x.device}")
    for t in tensors:
        if t.device != x.device or (x.device.type == "cuda"
                                    and not t.is_contiguous()):
            raise ValueError(f"{name}: tensors must be contiguous and on "
                             f"{x.device}")


def conv3x3_forward(x, w):
    """Same contract as conv3x3_forward_reference. A CPU ``x`` runs the
    plain version; a CUDA ``x`` launches the forward kernel on the current
    stream and counts it in ``conv3x3_forward.launches``; any other device
    raises."""
    _check("conv3x3_forward", x, w)
    if x.device.type == "cpu":
        return conv3x3_forward_reference(x, w)
    from . import _build

    B, _, H, _ = x.shape
    O = H - F + 1
    out = torch.empty((B, w.shape[0], O, O), dtype=x.dtype, device=x.device)
    _build.conv3x3_forward_launch(x, w, out)
    conv3x3_forward.launches += 1
    return out


def conv3x3_backward(x, w, dz):
    """Same contract as conv3x3_backward_reference; the device rule of
    conv3x3_forward, counted in ``conv3x3_backward.launches``."""
    _check("conv3x3_backward", x, w, dz)
    if x.device.type == "cpu":
        return conv3x3_backward_reference(x, w, dz)
    from . import _build

    M, C = w.shape[0], w.shape[1]
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    part = torch.empty((min(x.shape[0], DW_SPLITS), M, F * F * C),
                       dtype=torch.float32, device=x.device)
    _build.conv3x3_backward_launch(x, w, dz, dx, dw, part)
    conv3x3_backward.launches += 1
    return dx, dw


conv3x3_forward.launches = 0
conv3x3_backward.launches = 0


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_forward(x, w)

    @staticmethod
    def backward(ctx, dz):
        x, w = ctx.saved_tensors
        return conv3x3_backward(x, w, dz.contiguous())


def conv3x3_valid(x, w):
    """3x3 stride-1 valid CORRELATION (the caller handles any filter flip),
    differentiable in x and w: x (B, C, H, H), w (M, C, 3, 3) -> (B, M,
    H-2, H-2) in x's dtype (conv_pallas.py:218-247)."""
    return _Conv3x3.apply(x.contiguous(), w.contiguous())

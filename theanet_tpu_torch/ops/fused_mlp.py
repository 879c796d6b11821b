"""The dense tail Hidden -> leaky relu -> dropout -> Softmax as one
autograd function (the ``FUSED_TAIL`` training option).

Port of ``theanet_tpu/ops/fused_mlp.py``: ``_fwd_kernel`` and
``_bwd_kernel`` become the forward and backward of
``csrc/fused_mlp.cu``, and ``jax.custom_vjp`` becomes
``torch.autograd.Function``.

  * ``tail_forward_reference`` / ``tail_backward_reference`` are the plain
    PyTorch versions: the specification the kernels are held to, and what
    CPU tensors run.
  * ``tail_forward`` / ``tail_backward`` are the wrappers: CPU tensors run
    the plain version, CUDA tensors launch the kernel (counted in
    ``tail_forward.launches`` and ``tail_backward.launches``), any other
    device raises.
  * ``fused_hidden_softmax`` is the autograd function: it saves
    ``(x, w1, w2, h, mask, logp)`` as ``_fused_fwd`` does and its backward
    returns dx, dw1, db1, dw2 and db2. Weight-cost gradients and the
    update stay outside, as in the JAX package.

Dropout reads injected int32 words (B, n_hid): a unit is kept where the
word's low 24 bits, as a uniform in [0, 1), are >= pdrop. Eval scales by
(1 - pdrop) (scale-at-test).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["FusedTailSpec", "tail_forward_reference",
           "tail_backward_reference", "tail_forward", "tail_backward",
           "fused_hidden_softmax"]


class FusedTailSpec(NamedTuple):
    slope: float    # leaky-relu negative slope (relu 0, linear 1, reluNN NN/100)
    pdrop: float
    train: bool


def _drop_mode(spec):
    """0: no dropout, 1: train mask from the words, 2: eval scale."""
    if not spec.pdrop:
        return 0
    return 1 if spec.train else 2


def tail_forward_reference(x, w1, b1, w2, b2, words, spec: FusedTailSpec):
    """(logp, h, mask) of the tail (fused_mlp.py:39-74): z1 = x w1 + b1,
    h = leaky(z1) * mask (train) or * (1 - pdrop) (eval), logp =
    log_softmax(h w2 + b2)."""
    z1 = x @ w1 + b1
    h = torch.clamp(z1, min=0.0) + torch.clamp(z1, max=0.0) * spec.slope
    mode = _drop_mode(spec)
    if mode == 1:
        u = (words & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
        mask = (u >= spec.pdrop).to(torch.float32)
        h = h * mask
    else:
        mask = torch.ones_like(h)
        if mode == 2:
            h = h * (1.0 - spec.pdrop)
    z2 = h @ w2 + b2
    m = z2.max(dim=1, keepdim=True).values
    lse = m + torch.log(torch.exp(z2 - m).sum(dim=1, keepdim=True))
    return z2 - lse, h, mask


def tail_backward_reference(x, w1, w2, h, mask, logp, g,
                            spec: FusedTailSpec):
    """(dx, dw1, db1, dw2, db2) from g = dL/dlogp (fused_mlp.py:77-118).
    leaky' comes from the sign of the saved h: the activation keeps the
    pre-activation's sign, and a dropped unit's dh is already 0."""
    dz2 = g - torch.exp(logp) * g.sum(dim=1, keepdim=True)
    dw2 = h.T @ dz2
    db2 = dz2.sum(dim=0)
    dh = dz2 @ w2.T
    mode = _drop_mode(spec)
    if mode == 1:
        dh = dh * mask
    elif mode == 2:
        dh = dh * (1.0 - spec.pdrop)
    dz1 = dh * torch.where(h > 0, 1.0, spec.slope).to(torch.float32)
    return dz1 @ w1.T, x.T @ dz1, dz1.sum(dim=0), dw2, db2


def _check(name, tensors):
    """Raise unless each (tensor, shape, dtype) is as the kernel reads it,
    on the first tensor's device and contiguous."""
    dev = tensors[0][0].device
    for t, shape, dtype in tensors:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, "
                             f"expected {tuple(shape)} {dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous and on "
                             f"{dev}")


def _dims(x, w1, w2):
    return x.shape[0], x.shape[1], w1.shape[1], w2.shape[1]


def tail_forward(x, w1, b1, w2, b2, words, spec: FusedTailSpec):
    """Same contract as tail_forward_reference. A CPU ``x`` runs the plain
    version; a CUDA ``x`` launches the forward kernel on the current stream
    and counts it in ``tail_forward.launches``; any other device raises."""
    if x.device.type == "cpu":
        return tail_forward_reference(x, w1, b1, w2, b2, words, spec)
    if x.device.type != "cuda":
        raise ValueError(f"tail_forward: no kernel for {x.device}")
    B, K, NH, O = _dims(x, w1, w2)
    f32 = torch.float32
    want = [(x, (B, K), f32), (w1, (K, NH), f32), (b1, (NH,), f32),
            (w2, (NH, O), f32), (b2, (O,), f32)]
    mode = _drop_mode(spec)
    if mode == 1:
        want.append((words, (B, NH), torch.int32))
    _check("tail_forward", want)
    from . import _build

    logp = torch.empty((B, O), dtype=f32, device=x.device)
    h = torch.empty((B, NH), dtype=f32, device=x.device)
    mask = torch.empty_like(h)
    _build.fused_mlp_forward_launch(
        x, w1, b1, w2, b2, words if mode == 1 else None, logp, h, mask,
        spec.slope, spec.pdrop, 1.0 - spec.pdrop, mode)
    tail_forward.launches += 1
    return logp, h, mask


def tail_backward(x, w1, w2, h, mask, logp, g, spec: FusedTailSpec):
    """Same contract as tail_backward_reference; the device rule and the
    launch count (``tail_backward.launches``) of tail_forward."""
    if x.device.type == "cpu":
        return tail_backward_reference(x, w1, w2, h, mask, logp, g, spec)
    if x.device.type != "cuda":
        raise ValueError(f"tail_backward: no kernel for {x.device}")
    B, K, NH, O = _dims(x, w1, w2)
    f32 = torch.float32
    _check("tail_backward", [(x, (B, K), f32), (w1, (K, NH), f32),
                             (w2, (NH, O), f32), (h, (B, NH), f32),
                             (mask, (B, NH), f32), (logp, (B, O), f32),
                             (g, (B, O), f32)])
    from . import _build

    def new(*shape):
        return torch.empty(shape, dtype=f32, device=x.device)

    dx, dw1, db1, dw2, db2 = new(B, K), new(K, NH), new(NH), new(NH, O), new(O)
    _build.fused_mlp_backward_launch(
        x, w1, w2, h, mask, logp, g, dx, dw1, db1, dw2, db2, new(B, O),
        new(B, NH), spec.slope, 1.0 - spec.pdrop, _drop_mode(spec))
    tail_backward.launches += 1
    return dx, dw1, db1, dw2, db2


tail_forward.launches = 0
tail_backward.launches = 0


class _FusedTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, words, spec):
        logp, h, mask = tail_forward(x, w1, b1, w2, b2, words, spec)
        ctx.spec = spec
        ctx.save_for_backward(x, w1, w2, h, mask, logp)
        return logp

    @staticmethod
    def backward(ctx, g):
        x, w1, w2, h, mask, logp = ctx.saved_tensors
        grads = tail_backward(x, w1, w2, h, mask, logp, g.contiguous(),
                              ctx.spec)
        return grads + (None, None)


def fused_hidden_softmax(x, w1, b1, w2, b2, words, spec: FusedTailSpec):
    """logp (B, n_out) of the tail, differentiable in x, w1, b1, w2 and b2
    (fused_mlp.py:121-191). ``words`` (B, n_hid) int32 are read only in
    train mode with pdrop > 0 (else may be None)."""
    return _FusedTail.apply(x.contiguous(), w1.contiguous(), b1.contiguous(),
                            w2.contiguous(), b2.contiguous(), words, spec)

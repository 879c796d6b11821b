"""Convolution and pooling layers: ConvLayer, PoolLayer, MeanLayer (port of
``theanet_tpu/layers/conv.py``; reference theanet/layer/convpool.py)."""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from ..activations import activation_by_name
from ..inits import init_wb
from .base import Layer

__all__ = ["ConvLayer", "PoolLayer", "MeanLayer", "maxpool"]


def _use_conv3x3(x, w, mode, stride):
    """Route an eligible conv to ``ops.conv3x3`` (csrc/conv3x3.cu on a
    card) when THEANET_PALLAS_CONV=1: the switch and the predicate of
    theanet_tpu/layers/conv.py:23-38, so one environment picks the same
    path in both packages. Opt-in: off, the conv is ``F.conv2d``."""
    if os.environ.get("THEANET_PALLAS_CONV") != "1":
        return False
    from ..ops.conv3x3 import eligible

    return eligible(x.shape, w.shape, mode, stride)


class ConvLayer(Layer):
    """2-D TRUE convolution with static shapes (reference convpool.py:14-95).

    Theano's conv2d flips the filter; weights stay in the reference layout
    and the flip happens in ``apply``. Modes 'valid', 'full' and 'same'
    (same = full conv, then a centre crop; stride 1). The reference books a
    'full' conv's output size as in + filter + 1 (convpool.py:64) although
    the tensor is in + filter - 1; the bookkeeping is kept as it is.
    """

    def __init__(self, wts, rand_gen, batch_sz, num_prev_maps, in_sz,
                 num_maps, filter_sz, stride, mode="valid", actvn="relu50",
                 reg=()):
        super().__init__()
        assert wts is not None or rand_gen is not None
        assert mode in ("valid", "full", "same")
        filter_shape = (num_maps, num_prev_maps, filter_sz, filter_sz)
        fan_in = num_prev_maps * filter_sz * filter_sz
        fan_out = num_maps * filter_sz * filter_sz
        w, b = init_wb(wts, rand_gen, filter_shape, (num_maps,), fan_in,
                       fan_out, actvn)
        self.params_init = [w, b]

        if mode == "same":
            assert stride == 1, "For Same mode stride should be 1"
            self.out_sz = in_sz
        elif mode == "full":
            self.out_sz = in_sz + filter_sz + 1  # reference convpool.py:64
        else:
            self.out_sz = in_sz - filter_sz + 1
        self.out_sz //= stride

        self.in_sz = in_sz
        self.num_maps = num_maps
        self.num_prev_maps = num_prev_maps
        self.filter_sz = filter_sz
        self.stride = stride
        self.mode = mode
        self.actvn = actvn
        self.n_out = num_maps * self.out_sz**2
        self.reg = self.make_reg(reg)
        self.representation = (
            "Conv Maps:{:2d} Filter:{} Stride:{} Mode:{} Output:{:2d} "
            "Act:{}\n\t  L1:{L1} L2:{L2} Momentum:{momentum} Rate:{rate} "
            "Max Norm:{maxnorm}".format(
                num_maps, filter_sz, stride, mode, self.out_sz, actvn,
                **self.reg,
            )
        )

    def apply(self, wts, x, *, train, generator=None):
        w, b = wts
        w = torch.flip(w, (2, 3))
        f = self.filter_sz
        act = activation_by_name(self.actvn)
        if _use_conv3x3(x, w, self.mode, self.stride):
            from ..ops.conv3x3 import conv3x3_valid

            # bias and activation in f32, then back to the compute dtype
            # (theanet_tpu/layers/conv.py:113-119)
            out = conv3x3_valid(x, w).to(torch.float32)
            return act(out + b[None, :, None, None]).to(x.dtype)
        pad = 0 if self.mode == "valid" else f - 1
        out = F.conv2d(x, w, stride=self.stride, padding=pad)
        if self.mode == "same":
            s = (f - 1) // 2
            out = out[:, :, s:self.in_sz + s, s:self.in_sz + s]
        return act(out + b[None, :, None, None])


def pool_windows(x, p, ignore_border):
    """(B, M, o, p, o, p) view of x's non-overlapping p x p windows: ceil
    windows padded with -inf, or (ignore_border) the partial tail dropped."""
    in_sz = x.shape[2]
    o = in_sz // p if ignore_border else -(-in_sz // p)
    full = o * p
    if full > in_sz:
        x = F.pad(x, (0, full - in_sz, 0, full - in_sz), value=-math.inf)
    else:
        x = x[:, :, :full, :full]
    return x.reshape(x.shape[0], x.shape[1], o, p, o, p)


def pool_backward(r, pooled, g, in_sz):
    """Gradient of the window max to EVERY element equal to its window's
    max (Theano's MaxPoolGrad), from the windows ``r`` of pool_windows."""
    b, m, o, p = r.shape[0], r.shape[1], r.shape[2], r.shape[3]
    full = o * p
    gw = torch.where(r == pooled[:, :, :, None, :, None],
                     g[:, :, :, None, :, None],
                     torch.zeros((), dtype=g.dtype, device=g.device))
    gw = gw.reshape(b, m, full, full)
    if full > in_sz:
        return gw[:, :, :in_sz, :in_sz]
    if full < in_sz:
        return F.pad(gw, (0, in_sz - full, 0, in_sz - full))
    return gw


class _MaxPool(torch.autograd.Function):
    """Non-overlapping p x p max pool whose backward sends the output
    gradient to every tied maximum (reference convpool.py:97-127).
    ``F.max_pool2d`` sends it to one element only, which differs on the
    exact ties that flat background regions produce."""

    @staticmethod
    def forward(ctx, x, p, ignore_border):
        r = pool_windows(x, p, ignore_border)
        pooled = r.amax(dim=(3, 5))
        ctx.save_for_backward(r, pooled)
        ctx.in_sz = x.shape[2]
        return pooled

    @staticmethod
    def backward(ctx, g):
        r, pooled = ctx.saved_tensors
        return pool_backward(r, pooled, g, ctx.in_sz), None, None


def maxpool(x, pool_sz, ignore_border):
    """Max pool with the all-ties gradient; ceil windows unless
    ignore_border."""
    return _MaxPool.apply(x, pool_sz, bool(ignore_border))


class PoolLayer(Layer):
    """Max pooling (reference convpool.py:97-127). ignore_border=False keeps
    partial edge windows (out = ceil(in/p)); True floors."""

    def __init__(self, num_maps, in_sz, pool_sz, ignore_border=False):
        super().__init__()
        self.pool_sz = pool_sz
        self.ignore_border = ignore_border
        self.num_maps = num_maps
        self.in_sz = in_sz
        if ignore_border:
            self.out_sz = in_sz // pool_sz
        else:
            self.out_sz = math.ceil(in_sz / pool_sz)
        self.n_out = num_maps * self.out_sz**2
        self.representation = (
            "Pool Maps:{:2d} Pool_sz:{} Border:{} Output:{:2d}".format(
                num_maps, pool_sz, "Ignore" if ignore_border else "Keep",
                self.out_sz))

    def apply(self, wts, x, *, train, generator=None):
        # pool the ACTUAL tensor, like Theano's pool_2d (see the JAX port)
        return maxpool(x, self.pool_sz, self.ignore_border)


class MeanLayer(Layer):
    """Global average pool over the spatial dims (reference
    convpool.py:129-144): (B, M, S, S) -> (B, M)."""

    def __init__(self, num_maps, in_sz):
        super().__init__()
        self.num_maps = num_maps
        self.in_sz = in_sz
        self.out_sz = 1
        self.n_out = num_maps
        self.representation = "Mean Maps:{:2d} Output:{:2d}".format(
            num_maps, self.out_sz)

    def apply(self, wts, x, *, train, generator=None):
        return torch.mean(x, dim=(2, 3))

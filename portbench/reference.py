"""The plain reference the benchmark holds the port to.

Plain PyTorch and NumPy. It imports neither JAX nor anything of the port,
and takes nothing the port made: it draws the initial weights from the
seed itself (the reference's numpy draws, a copy of the port's
``inits.py``), draws each epoch's noise words itself (``noise.py``),
arranges the benchmark's data into step rows itself, and trains and
evaluates from there.

The training step is a frozen copy of the port's plain twins
(``megastep_epoch_reference`` and ``deep_epoch_reference``, which the
CUDA epoch kernels are held to step by step), cut down to the benchmark's
grammar (``netdesc.py``): the nearest-pixel elastic warp, invert and
pflip from injected words, the conv levels summed tap by tap in the
kernels' order, every max-pool tie taking the gradient, the hidden layer
with its dropout mask from the words, the Softmax(nll) head, the
hand-derived backward, and the old-accumulator momentum update with
max-norm. The evaluation is the per-layer eval forward of the reference's
layers (invert only, scale-at-test dropout).

Every product goes through a ``Precision``: ``F32`` computes in float32
with TF32 off (``exact_f32`` turns the library's TF32 off around every
reference call, whatever the process has set, and restores it after); ``TF32`` rounds each product's operands to TF32 (10 bits
of mantissa, round to nearest even) and sums in float32, which is what a
TF32 path computes. ``TF32`` is the control that the comparison has to
refuse. ``F32_ACC64`` sums the dense and gradient products in float64 and
rounds once: another sound float32 implementation, the witness of how far
two sound ones drift apart over an epoch.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

MASK24 = 0xFFFFFF
INV24 = 1.0 / (1 << 24)


class Precision:
    """How a product is computed: float32 operands summed in float32;
    operands rounded to TF32 (``tf32``); or float32 operands summed in
    float64 and rounded once (``acc64``, a sound float32 result in another
    summation order)."""

    def __init__(self, name, tf32=False, acc64=False):
        self.name, self.tf32, self.acc64 = name, tf32, acc64

    def r(self, t):
        if not self.tf32:
            return t
        i = t.contiguous().view(torch.int32)
        i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
        return i.view(torch.float32)

    def mm(self, a, b):
        if self.acc64:
            return torch.matmul(a.double(), b.double()).float()
        return torch.matmul(self.r(a), self.r(b))

    def einsum(self, eq, a, b):
        if self.acc64:
            return torch.einsum(eq, a.double(), b.double()).float()
        return torch.einsum(eq, self.r(a), self.r(b))


F32 = Precision("float32")
TF32 = Precision("tf32", tf32=True)
F32_ACC64 = Precision("float32, products summed in float64", acc64=True)


def _tf32_switches():
    """[(object, attribute, its value for TF32 off)] of the library's
    float32 matrix products and convolutions: the per-backend precision
    settings where this torch has them, else the allow_tf32 flags."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    if hasattr(mm, "fp32_precision") and hasattr(dnn, "conv"):
        return [(mm, "fp32_precision", "ieee"),
                (dnn.conv, "fp32_precision", "ieee")]
    return [(mm, "allow_tf32", False), (dnn, "allow_tf32", False)]


def tf32_off():
    return all(getattr(o, k) == off for o, k, off in _tf32_switches())


@contextmanager
def exact_f32():
    """TF32 off for the library's float32 products and convolutions inside,
    whatever the process set before; the settings restored after."""
    switches = _tf32_switches()
    old = [getattr(o, k) for o, k, _ in switches]
    for o, k, off in switches:
        setattr(o, k, off)
    try:
        yield
    finally:
        for (o, k, _), v in zip(switches, old):
            setattr(o, k, v)


# ------------------------------------------------------------------- init

def _init_wb(rng, size_w, fan_in, fan_out, actvn):
    """The reference's draws of one layer's (w, b) (weights.py:25-81; the
    port's ``inits.init_wb``)."""
    if len(size_w) == 4:
        w = 2.0 * rng.randint(2, size=size_w) - 1
        w /= np.sqrt(fan_in)
    else:
        w = rng.uniform(low=-1, high=1, size=size_w)
        w *= np.sqrt(6.0 / (fan_in + fan_out))
    w = np.asarray(w, dtype=np.float32)
    b = np.zeros(size_w[0] if len(size_w) == 4 else size_w[1],
                 dtype=np.float32)
    if actvn == "sigmoid":
        w = w * 4
    if actvn in ("softplus", "relu") or actvn.startswith("relu0"):
        b = b + np.float32(0.5)
    return w, b


def _consume_stream_seed(rng):
    rng.randint(int(1e6))


def init_framework(layers, net, seed):
    """The initial weights of ``net`` from numpy's RandomState(seed), drawn
    in the reference's layer-constructor order (stochastic layers take one
    stream-seed draw): per parameterised layer [w, b] in the reference's
    layout."""
    rng = np.random.RandomState(seed)
    out, k = [], 0
    prev_out = net.in_ch * net.hw
    for name, args in layers:
        if name == "ElasticLayer":
            if net.warp_active or net.elastic["pflip"]:
                _consume_stream_seed(rng)
        elif name == "ConvLayer":
            lv = net.levels[k]
            w, b = _init_wb(rng, (lv.maps, lv.cin, lv.filt, lv.filt),
                            lv.cin * lv.filt ** 2, lv.maps * lv.filt ** 2,
                            lv.actvn)
            out.append([w, b])
            prev_out = lv.maps * lv.side_pool ** 2
            k += 1
        elif name == "HiddenLayer":
            fan = prev_out + net.n_hid
            out.append(list(_init_wb(rng, (prev_out, net.n_hid), fan, fan,
                                     net.hid_actvn)))
            if net.pdrop:
                _consume_stream_seed(rng)
            prev_out = net.n_hid
        elif name == "SoftmaxLayer":
            fan = prev_out + net.n_out
            out.append(list(_init_wb(rng, (prev_out, net.n_out), fan, fan,
                                     "Softmax")))
    return out


def to_leaves(fw, net, device):
    """Reference-layout weights (per layer [w, b], numpy or tensors; layers
    without weights are skipped) -> the training state's leaves
    (``Net.state_shapes``) as float32 tensors on ``device``: conv weights
    (M, Cin, F, F) -> (M, F*F*Cin) indexed (u*F+v)*Cin + c, conv biases
    columns, dense biases rows."""
    def t(a):
        if torch.is_tensor(a):
            return a.detach().to(device, torch.float32).clone()
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    fw = [lw for lw in fw if len(lw)]
    out = []
    for k, lv in enumerate(net.levels):
        w, b = t(fw[k][0]), t(fw[k][1])
        out += [w.permute(0, 2, 3, 1).reshape(lv.maps, -1).contiguous(),
                b.reshape(lv.maps, 1).contiguous()]
    for lw in fw[len(net.levels):]:
        out += [t(lw[0]).contiguous(), t(lw[1]).reshape(1, -1).contiguous()]
    return out


def arrange(net, x, y, device):
    """The training set as step rows: x (n, C0, H, W) -> (nb, C0*B, HW)
    channel-major rows of each batch, y -> (nb, B) int32."""
    B, C0, HW = net.batch, net.in_ch, net.hw
    nb = x.shape[0] // B
    xt = torch.as_tensor(np.asarray(x[:nb * B], np.float32), device=device)
    xs = (xt.reshape(nb, B, C0, HW).transpose(1, 2)
          .reshape(nb, C0 * B, HW).contiguous())
    ys = torch.as_tensor(np.asarray(y[:nb * B], np.int32),
                         device=device).reshape(nb, B)
    return xs, ys


# ------------------------------------------------------------ augmentation

def _u01(bits):
    return (bits & MASK24).to(torch.float32) * INV24


def gaussian_bands(n, sigma):
    """The banded matrix G with G @ field @ G^T the reference's Gaussian
    smoothing of the elastic field."""
    var = float(sigma) ** 2
    taps = np.arange(-sigma, sigma + 1, dtype=np.float64)
    k1 = np.exp(-0.5 * taps * taps / var) / math.sqrt(2 * math.pi * var)
    g = np.zeros((n, n), dtype=np.float32)
    for d, v in zip(range(-sigma, sigma + 1), k1):
        idx = np.arange(max(0, -d), min(n, n - d))
        g[idx, idx + d] = v
    return g


def smoothing_factors(net, device):
    H = net.img
    if not net.elastic["magnitude"]:
        z = torch.zeros((H, H), dtype=torch.float32, device=device)
        return z, z
    g = gaussian_bands(H, max(int(net.elastic["sigma"]), 1))
    return (torch.as_tensor(g, device=device),
            torch.as_tensor(g.copy(), device=device))


def _smooth(gh, n, gw):
    """G_h @ n @ G_w^T summed k = 0, 1, ... one multiply and one add a
    term: the kernels' order."""
    p = gh[:, :, None] * n[..., None, :, :]
    t = torch.zeros_like(n)
    for k in range(n.shape[-2]):
        t = t + p[..., k, :]
    q = t[..., :, None, :] * gw
    s = torch.zeros_like(n)
    for k in range(n.shape[-1]):
        s = s + q[..., k]
    return s


def warp_field(net, ub, fb, gh, gw):
    """The step's warp target (ty, tx), each (HW,), from its affine words
    ``ub`` (8,) and field words ``fb``."""
    e, H, HW = net.elastic, net.img, net.hw
    q = torch.arange(HW, device=ub.device)
    ty = (q // H).to(torch.float32)
    tx = (q % H).to(torch.float32)
    u = 2.0 * _u01(ub) - 1.0
    if e["translation"]:
        ty = ty + e["translation"] * u[0]
        tx = tx + e["translation"] * u[1]
    if e["magnitude"]:
        u1a = ((fb[0] & MASK24).to(torch.float32) + 0.5) * INV24
        u2a = _u01(fb[1])
        u1b = ((fb[2] & MASK24).to(torch.float32) + 0.5) * INV24
        u2b = _u01(fb[3])
        n0 = e["magnitude"] * (torch.sqrt(-2.0 * torch.log(u1a))
                               * torch.cos(2.0 * math.pi * u2a))
        n1 = e["magnitude"] * (torch.sqrt(-2.0 * torch.log(u1b))
                               * torch.sin(2.0 * math.pi * u2b))
        ty = ty + _smooth(gh, n0.reshape(H, H), gw).reshape(HW)
        tx = tx + _smooth(gh, n1.reshape(H, H), gw).reshape(HW)
    if e["zoom"] != 1 or e["angle"]:
        oy = (0.5 + 0.25 * u[2]) * H
        ox = (0.5 + 0.25 * u[3]) * H
        ty = ty - oy
        tx = tx - ox
        if e["zoom"] != 1:
            ty = ty * torch.exp(math.log(e["zoom"]) * u[4])
            tx = tx * torch.exp(math.log(e["zoom"]) * u[5])
        if e["angle"]:
            th = e["angle"] * math.pi / 180.0 * u[6]
            ct, st = torch.cos(th), torch.sin(th)
            ty, tx = ct * ty + st * tx, -st * ty + ct * tx
        ty = ty + oy
        tx = tx + ox
    hi = H - 1 - 0.001
    return torch.clamp(ty, 0.0, hi), torch.clamp(tx, 0.0, hi)


def augment(net, x, ub, fb, pb, gh, gw):
    """Invert -> resample every row of ``x`` (C0*B, HW) at the step's one
    warp, nearest floor(t+.5) -> pflip."""
    H, e = net.img, net.elastic
    if e["invert"]:
        x = 1.0 - x
    if net.warp_active:
        ty, tx = warp_field(net, ub, fb, gh, gw)
        x = x[:, torch.floor(ty + 0.5).long() * H
              + torch.floor(tx + 0.5).long()]
    if e["pflip"]:
        x = torch.where(_u01(pb) < e["pflip"], 1.0 - x, x)
    return x


# -------------------------------------------------------------- the layers

def _act(z, slope):
    return torch.clamp(z, min=0.0) + torch.clamp(z, max=0.0) * slope


def _dact(z, slope):
    return torch.where(z > 0, 1.0, slope).to(z.dtype)


def conv_true(x, w_k, filt, cin, P):
    """Valid true convolution of ``x`` (B, Cin, S, S) with kernel-layout
    weights (M, F*F*Cin), summed tap by tap in the order (u, v, c), one
    multiply and one add a tap: the kernels' order, on which exact max-pool
    ties depend."""
    x, w_k = P.r(x), P.r(w_k)
    side = x.shape[2] - filt + 1
    M = w_k.shape[0]
    z = torch.zeros((x.shape[0], M, side, side), dtype=x.dtype,
                    device=x.device)
    for u in range(filt):
        for v in range(filt):
            oy, ox = filt - 1 - u, filt - 1 - v
            for c in range(cin):
                w = w_k[:, (u * filt + v) * cin + c].reshape(1, M, 1, 1)
                z = z + w * x[:, c:c + 1, oy:oy + side, ox:ox + side]
    return z


def _corr_weights(w_k, filt, cin):
    w = w_k.reshape(w_k.shape[0], filt, filt, cin).permute(0, 3, 1, 2)
    return torch.flip(w, (2, 3)).reshape(w_k.shape[0], -1)


def conv_dgrad(dz, w_k, filt, cin, side_in, P):
    """d conv_true / d input: each output's gradient scattered back over
    its patch."""
    dcols = P.mm(_corr_weights(w_k, filt, cin).T,
                 dz.reshape(dz.shape[0], dz.shape[1], -1))
    return F.fold(dcols, (side_in, side_in), filt)


def conv_wgrad(x, dz, filt, P):
    """d conv_true / d w in kernel layout, one product over a patch
    matrix."""
    B, M = dz.shape[0], dz.shape[1]
    cols = F.unfold(x, filt)
    dwc = P.einsum("bml,bkl->mk", dz.reshape(B, M, -1), cols)
    dw = torch.flip(dwc.reshape(M, x.shape[1], filt, filt), (2, 3))
    return dw.permute(0, 2, 3, 1).reshape(M, -1)


def pool_windows(x, p, ignore_border):
    in_sz = x.shape[2]
    o = in_sz // p if ignore_border else -(-in_sz // p)
    full = o * p
    if full > in_sz:
        x = F.pad(x, (0, full - in_sz, 0, full - in_sz), value=-math.inf)
    else:
        x = x[:, :, :full, :full]
    return x.reshape(x.shape[0], x.shape[1], o, p, o, p)


def pool_backward(r, pooled, g, in_sz):
    """The window max's gradient to EVERY element equal to the max."""
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


def softmax_nll(z4, y, batch):
    """(mean NLL, least true-class log-prob, dL/dz4)."""
    onehot = F.one_hot(y.long(), z4.shape[1]).to(torch.float32)
    zc = z4 - z4.amax(dim=1, keepdim=True)
    logp = zc - torch.log(torch.exp(zc).sum(dim=1, keepdim=True))
    tl = (logp * onehot).sum(dim=1, keepdim=True)
    return (-tl.sum() / batch, tl.min(),
            (torch.exp(logp) - onehot) * (1.0 / batch))


def weight_cost(groups):
    cost = 0.0
    for reg, ts in groups:
        if reg["L1"]:
            cost = cost + reg["L1"] * sum(t.abs().sum() for t in ts)
        if reg["L2"]:
            cost = cost + reg["L2"] * sum((t * t).sum() for t in ts)
    return cost


# ---------------------------------------------------------------- training

def step(net, x, y, ub, fb, pb, db, params, gh, gw, P):
    """One training step: augmentation, forward, hand-derived backward.
    ``x`` (C0*B, HW) channel-major rows, ``y`` (B,), one step's words.
    Returns (cost, minf, grads) with grads in the leaves' layout."""
    B, H, C0, n = net.batch, net.img, net.in_ch, len(net.levels)
    ws, bs = params[0:2 * n:2], params[1:2 * n:2]
    wh, bh, wo, bo = params[2 * n:2 * n + 4]

    a = augment(net, x, ub, fb, pb, gh, gw)
    inp = a.reshape(C0, B, H, H).transpose(0, 1)
    saved = []
    for k, lv in enumerate(net.levels):
        z = conv_true(inp, ws[k], lv.filt, lv.cin, P) + bs[k].reshape(
            1, lv.maps, 1, 1)
        r = pool_windows(_act(z, lv.slope), lv.pool, lv.ib)
        p = r.amax(dim=(3, 5))
        saved.append((inp, z, r, p))
        inp = p
    f = inp.reshape(B, -1)
    cost = weight_cost([(lv.reg, (w, b))
                        for lv, w, b in zip(net.levels, ws, bs)])

    z3 = P.mm(f, wh) + bh
    h3 = _act(z3, net.hid_slope)
    mask3 = ((_u01(db[:, db.shape[1] - net.n_hid:]) >= net.pdrop)
             .to(torch.float32) if net.pdrop else None)
    h3d = h3 * mask3 if net.pdrop else h3
    z4 = P.mm(h3d, wo) + bo
    head_cost, minf, dz4 = softmax_nll(z4, y, B)
    cost = cost + head_cost + weight_cost([(net.hid_reg, (wh, bh)),
                                           (net.head_reg, (wo, bo))])

    dwo = P.mm(h3d.T, dz4)
    dbo = dz4.sum(dim=0, keepdim=True)
    dh3 = P.mm(dz4, wo.T)
    if net.pdrop:
        dh3 = dh3 * mask3
    dz3 = dh3 * _dact(z3, net.hid_slope)
    dwh = P.mm(f.T, dz3)
    dbh = dz3.sum(dim=0, keepdim=True)
    dp = P.mm(dz3, wh.T).reshape(saved[-1][3].shape)
    dconv = []
    for k in range(n - 1, -1, -1):
        lv = net.levels[k]
        inp, z, r, p = saved[k]
        dz = pool_backward(r, p, dp, lv.side_conv) * _dact(z, lv.slope)
        dconv.append((conv_wgrad(inp, dz, lv.filt, P),
                      dz.sum(dim=(0, 2, 3)).reshape(-1, 1)))
        if k:
            dp = conv_dgrad(dz, ws[k], lv.filt, lv.cin, lv.side_in, P)
    dconv.reverse()
    grads = [g for pair in dconv for g in pair] + [dwh, dbh, dwo, dbo]
    return cost, minf, grads


def _maxnorm(p, maxnorm, kind):
    if not maxnorm:
        return p
    if kind == "bias":
        return torch.clamp(p, -maxnorm, maxnorm)
    dim = 0 if kind == "cols" else 1
    norms = torch.sqrt((p * p).sum(dim=dim, keepdim=True))
    desired = torch.clamp(norms, 0.0, maxnorm)
    return p * ((1e-7 + desired) / (1e-7 + norms))


def apply_updates(kinds, params, moms, grads, lr):
    """Old-accumulator momentum and max-norm, in place (theanet's
    layer.py:82-103): p <- maxnorm(p - rate lr a_old), a <- m a + (1-m) g."""
    for p, a, g, (reg, kind) in zip(params, moms, grads, kinds):
        if not reg["rate"]:
            continue
        if reg["L2"]:
            g = g + (2.0 * reg["L2"]) * p
        if reg["L1"]:
            g = g + reg["L1"] * torch.sign(p)
        p_new = _maxnorm(p - (reg["rate"] * lr) * a, reg["maxnorm"], kind)
        a.copy_(reg["momentum"] * a + (1.0 - reg["momentum"]) * g)
        p.copy_(p_new)


@exact_f32()
@torch.no_grad()
def train_epoch(net, params, moms, x_steps, y_steps, bits, lr, P=F32,
                n_steps=None):
    """Train the first ``n_steps`` (default all) steps of an epoch from
    ``params``, ``moms`` (leaves, not modified). Returns (params, moms,
    costs (n,), grads of the first step)."""
    assert tf32_off()
    ub, fb, pb, db = bits
    nb = x_steps.shape[0] if n_steps is None else n_steps
    dev = x_steps.device
    lr = torch.tensor(lr, dtype=torch.float32, device=dev)
    params = [t.clone() for t in params]
    moms = [t.clone() for t in moms]
    gh, gw = smoothing_factors(net, dev)
    kinds = net.leaf_regs()
    costs = torch.empty((nb,), dtype=torch.float32, device=dev)
    first = None
    for s in range(nb):
        cost, _, grads = step(net, x_steps[s], y_steps[s], ub[s, 0], fb[s],
                              pb[s], db[s], params, gh, gw, P)
        costs[s] = cost
        if first is None:
            first = [g.clone() for g in grads]
        apply_updates(kinds, params, moms, grads, lr)
    return params, moms, costs, first


# -------------------------------------------------------------- evaluation

@exact_f32()
@torch.no_grad()
def eval_stats(net, leaves, x, y, P=F32):
    """The eval window's statistics of the state ``leaves`` on images ``x``
    (n, C0, H, W) and labels ``y``: (error %, mean true-class probability
    %, wrong predictions), by the per-layer eval forward: invert only, each
    conv as a library convolution of the flipped filter, the hidden
    layer's output scaled by 1 - pdrop."""
    assert tf32_off()
    h = x
    if net.elastic["invert"]:
        h = 1.0 - h
    for k, lv in enumerate(net.levels):
        w = leaves[2 * k].reshape(lv.maps, lv.filt, lv.filt, lv.cin).permute(
            0, 3, 1, 2)
        z = F.conv2d(P.r(h), P.r(torch.flip(w, (2, 3)).contiguous()))
        h = _act(z + leaves[2 * k + 1].reshape(1, lv.maps, 1, 1), lv.slope)
        h = pool_windows(h, lv.pool, lv.ib).amax(dim=(3, 5))
    n = 2 * len(net.levels)
    wh, bh, wo, bo = leaves[n:n + 4]
    h = _act(P.mm(h.reshape(h.shape[0], -1), wh) + bh, net.hid_slope)
    if net.pdrop:
        h = h * (1.0 - net.pdrop)
    probs = torch.softmax(P.mm(h, wo) + bo, dim=-1)
    yl = y.long()
    wrong = torch.argmax(probs, dim=1) != yl
    p_true = probs[torch.arange(probs.shape[0], device=probs.device), yl]
    return (100.0 * float(torch.mean(wrong.to(torch.float32))),
            100.0 * float(torch.mean(p_true)), int(wrong.sum()))

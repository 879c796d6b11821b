"""Whole-epoch fused training of the 2-conv flagship net.

Port of ``theanet_tpu/ops/megastep.py``. One call trains a whole epoch of
Input/Elastic -> Conv -> Pool -> Conv -> Pool -> Hidden -> Softmax(nll):
per step, elastic augmentation from injected bits, the forward pass, the
hand-derived backward, L1/L2 gradients and the reference's old-accumulator
momentum + max-norm update.

  * ``megastep_epoch_reference`` is the plain PyTorch twin: the specification
    the CUDA kernel is held to, and what CPU tensors run.
  * ``megastep_epoch`` is the wrapper: CPU tensors go to the twin; CUDA
    tensors launch the hand-written kernel (``csrc/megastep.cu``, built at
    first use by ``ops/_build.py``) or raise. It counts its kernel launches
    in ``megastep_epoch.launches``.

This module also holds what the three fused families share (the deep family
in ``megastep_deep.py``, the flat MLP in ``megastep_mlp.py``): the noise
words, the augmentation with its ColorLayer transform, the Softmax and
CenteredOut heads, the update, and ``fused_plan``, which tries the families
in the JAX package's order: flagship, flat MLP, deep.

Randomness is INJECTED: ``epoch_noise_bits`` draws one epoch of 32-bit words
(held as int32) on the data's device; the step reads uniforms from their low
24 bits. Shapes and the bit -> variable mapping are the JAX package's
(``megastep.py:1297-1456``), so a test can hand the same words to both.

The TPU layout workarounds (striped or grouped lane slots, the kron (hw, hw)
smoothing operand, one-hot movement matmuls, SMEM stat blocks) are not
carried over: both the twin and the kernel compute the same function on
plain (batch, maps, y, x) tensors.

Kernel-layout state: conv weights flatten their taps channel-minor, w1
(M1, C0, F, F) -> (M1, F*F*C0) indexed (u*F+v)*C0 + c; biases are columns
(conv) or rows (dense); dense weights pass through.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..layers.conv import pool_backward, pool_windows
from . import route

__all__ = ["LayerReg", "MegaSpec", "act_of", "spec_from_net",
           "warp_smem_ok", "flagship_head_smem", "warp_limit_reason",
           "route_reason", "flagship_spec", "flagship_route_reason",
           "fused_decline_reason", "fused_plan", "FusedPlan",
           "MEGA_LAYER_IDX", "kernel_shapes", "kernel_layout",
           "framework_layout", "db_lanes", "fb_lanes", "epoch_noise_bits",
           "color_rows", "softmax_nll", "centered_nll",
           "megastep_epoch_reference", "megastep_epoch",
           "step_constants", "megastep_grad_step_reference",
           "megastep_grad_step",
           "megastep_update_reference", "megastep_update"]

# indices of the four parameterized layers in the flagship pattern
MEGA_LAYER_IDX = (1, 3, 5, 6)
MASK24 = 0xFFFFFF
INV24 = 1.0 / (1 << 24)


class LayerReg(NamedTuple):
    L1: float
    L2: float
    momentum: float
    rate: float
    maxnorm: float


class MegaSpec(NamedTuple):
    """The flagship net's static description. Unlike the TPU spec it has
    no layout knobs (group_g, n_tiles/loss_div, exact_movement, unroll): the
    card takes the whole BATCH_SZ in one step. A reference batch the JAX
    package runs as tiles (gradients summed over the tiles, one update a
    batch) is one step of the whole batch here, and a head beyond the
    shared memory a block can opt in to keeps its scratch in the
    workspace (csrc/megastep.cu step_setup)."""
    batch: int
    img: int            # input H = W
    filt1: int
    filt2: int
    maps1: int
    maps2: int
    n_hid: int
    n_out: int
    slope1: float       # negative slope of a 'leaky' activation
    slope2: float
    slope_h: float
    pdrop: float
    # elastic config (reference inlayers.py:30-40)
    translation: float
    zoom: float
    magnitude: float
    sigma: int
    pflip: float
    angle: float
    invert: bool
    nearest: bool
    reg1: LayerReg
    reg2: LayerReg
    reg_h: LayerReg
    reg_o: LayerReg
    in_ch: int = 1
    pool1: int = 2
    pool2: int = 2
    ib1: bool = False   # PoolLayer ignore_border
    ib2: bool = False
    act1: str = "leaky"  # activation kinds, see act_of
    act2: str = "leaky"
    act_h: str = "leaky"

    @property
    def hw(self):
        return self.img * self.img

    @property
    def c1(self):
        return self.img - self.filt1 + 1

    @property
    def p1(self):
        return self.c1 // self.pool1 if self.ib1 else -(-self.c1 // self.pool1)

    @property
    def c2(self):
        return self.p1 - self.filt2 + 1

    @property
    def p2(self):
        return self.c2 // self.pool2 if self.ib2 else -(-self.c2 // self.pool2)

    @property
    def n_flat(self):
        return self.maps2 * self.p2 * self.p2


def warp_active(spec):
    """True when the config moves coordinates (translation, elastic field,
    zoom or rotation); pflip and invert are per pixel."""
    return bool(spec.translation or spec.magnitude or spec.angle
                or spec.zoom != 1)


# ------------------------------------------------------------- route rule
# A fused family takes a spec whose grammar holds when the JAX package's
# byte model admits it (``route.py``) or its head fits a block's shared
# memory. The head stage takes any head at launch (in shared memory up to
# the opt-in, else in the workspace); the warp field stays a launch limit.
# The same rule runs on the CPU and on a card, so a net takes one route.

SMEM_OPT_IN = 227 * 1024      # the most a block can opt in to (sm_90)


def warp_smem_ok(hw):
    """csrc/stages.cuh ``warp_smem_ok`` (called in the step_setup of
    megastep.cu and megastep_deep.cu): k_warp keeps 4 floats a pixel in
    dynamic shared memory, opting in above 48 KB up to 227 KB."""
    return 4 * 4 * hw <= SMEM_OPT_IN


def flagship_head_smem(spec):
    """csrc/megastep.cu step_setup: k_head's scratch, (2 B NC + B) floats;
    shared memory up to the opt-in, else a workspace region."""
    return 4 * (2 * spec.batch * spec.n_out + spec.batch)


def warp_limit_reason(spec):
    """Why a fused kernel would refuse ``spec`` at launch (None when it
    takes it): a warp field (active warp) that ``warp_smem_ok`` refuses."""
    if warp_active(spec) and not warp_smem_ok(spec.hw):
        return (f"the warp field's shared memory: a {spec.img}x{spec.img} "
                f"image needs {16 * spec.hw:,} bytes, above the "
                f"{SMEM_OPT_IN:,} a block can hold (csrc/stages.cuh "
                "warp_smem_ok)")
    return None


def route_reason(spec, jax_reason, head_bytes, head_src):
    """Why a family declines ``spec`` (None when it takes it): the warp
    launch limit, else the route rule, which takes the spec when the JAX
    package's byte model admits it (``jax_reason`` None) or its head of
    ``head_bytes`` fits the shared memory a block can opt in to
    (``head_src`` names the C formula). The reason names both rules."""
    warp = warp_limit_reason(spec)
    if warp or jax_reason is None or head_bytes <= SMEM_OPT_IN:
        return warp
    return (f"the route rule: {jax_reason}, and the head does not fit "
            f"shared memory (BATCH_SZ {spec.batch} x {spec.n_out} outputs "
            f"needs {head_bytes:,} bytes, above the {SMEM_OPT_IN:,} a "
            f"block can opt in to, {head_src})")


# ----------------------------------------------------------------- matcher

_SMOOTH_ACTS = ("tanh", "scaled_tanh", "sigmoid", "softplus")


def act_of(actvn):
    """Fused activation tag ``(kind, slope)``: the leaky-relu family with its
    negative slope, or one of the smooth registry activations; None when the
    name does not fuse (softmax as a hidden activation)."""
    if actvn == "relu":
        return ("leaky", 0.0)
    if actvn == "linear":
        return ("leaky", 1.0)
    if actvn.startswith("relu") and actvn[4:].isdigit() and len(actvn) == 6:
        return ("leaky", int(actvn[4:]) / 100.0)
    if actvn in _SMOOTH_ACTS:
        return (actvn, 0.0)
    return None


def aug_of(layer0):
    """Elastic config fields for a spec (identity for a plain InputLayer)."""
    from ..layers import ElasticLayer

    if type(layer0) is ElasticLayer:
        cfg = layer0.cfg
        return dict(translation=cfg.translation, zoom=cfg.zoom,
                    magnitude=cfg.magnitude, sigma=int(cfg.sigma),
                    pflip=cfg.pflip, angle=cfg.angle,
                    invert=bool(cfg.invert_image), nearest=bool(cfg.nearest))
    return dict(translation=0, zoom=1, magnitude=0, sigma=1, pflip=0.0,
                angle=0, invert=False, nearest=False)


def reg_of(lyr):
    r = lyr.reg
    return LayerReg(L1=float(r["L1"]), L2=float(r["L2"]),
                    momentum=float(r["momentum"]), rate=float(r["rate"]),
                    maxnorm=float(r["maxnorm"]))


def flagship_spec(net):
    """The MegaSpec of ``net`` when it has the flagship pattern, before the
    route rule; else None."""
    from ..layers import (ConvLayer, ElasticLayer, HiddenLayer, InputLayer,
                          PoolLayer, SoftmaxLayer)

    L = net.net_layers
    kinds = (InputLayer, ElasticLayer)
    if net.fused_tail:
        return None
    if not (len(L) == 7 and type(L[0]) in kinds
            and type(L[1]) is ConvLayer and type(L[2]) is PoolLayer
            and type(L[3]) is ConvLayer and type(L[4]) is PoolLayer
            and type(L[5]) is HiddenLayer and type(L[6]) is SoftmaxLayer):
        return None
    c1, p1, c2, p2, hid, head = L[1], L[2], L[3], L[4], L[5], L[6]
    in_ch = L[0].num_maps
    acts = [act_of(c1.actvn), act_of(c2.actvn), act_of(hid.actvn)]
    if (c1.num_prev_maps != in_ch
            or any(c.stride != 1 or c.mode != "valid" for c in (c1, c2))
            or p1.pool_sz > c1.filter_sz or p2.pool_sz > c2.filter_sz
            or head.loss != "nll" or any(a is None for a in acts)
            or any(not lyr.reg["rate"] for lyr in (c1, c2, hid, head))):
        return None
    spec = MegaSpec(
        batch=net.batch_sz, img=L[0].out_sz,
        filt1=c1.filter_sz, filt2=c2.filter_sz,
        pool1=p1.pool_sz, pool2=p2.pool_sz,
        ib1=bool(p1.ignore_border), ib2=bool(p2.ignore_border),
        maps1=c1.num_maps, maps2=c2.num_maps, n_hid=hid.n_out,
        n_out=head.n_out, slope1=acts[0][1], slope2=acts[1][1],
        slope_h=acts[2][1], act1=acts[0][0], act2=acts[1][0],
        act_h=acts[2][0], pdrop=float(hid.pdrop), **aug_of(L[0]),
        reg1=reg_of(c1), reg2=reg_of(c2), reg_h=reg_of(hid),
        reg_o=reg_of(head), in_ch=in_ch,
    )
    return None if spec.p2 < 1 else spec


def spec_from_net(net):
    """A MegaSpec when ``net`` matches the flagship pattern and the route
    rule takes it, else None (the deep family, whose grammar holds this
    one, names the reason)."""
    spec = flagship_spec(net)
    return None if spec is None or flagship_route_reason(spec) else spec


def flagship_route_reason(spec):
    """``route_reason`` of a flagship spec: the JAX package's tile search
    and VMEM model, or the head's shared memory. A spec the JAX package
    tiles runs here as one step of the whole reference batch."""
    return route_reason(spec, route.flagship_jax_reason(spec),
                        flagship_head_smem(spec), "csrc/megastep.cu")


class FusedPlan(NamedTuple):
    """What the Trainer needs to drive a fused family: the matched spec,
    the net layers it owns, its epoch function and layout converters."""
    spec: object
    layer_idx: tuple
    epoch_fn: object
    kernel_layout: object
    framework_layout: object


# megastep.py:622-624: no fused family takes a FUSED_TAIL net
FUSED_TAIL_REASON = ("FUSED_TAIL is set (the XLA-fused tail variant keeps "
                     "the scanned path)")


def fused_plan(net, for_mesh=False, aux_data=True):
    """FusedPlan of the first family that matches ``net``, in the JAX
    package's order (megastep.py:569-600): the 2-conv flagship, then the
    bare flat MLP, then the deep family (any other conv depth, flat nets the
    MLP declines, CenteredOut, Hinge, ExpLoss and SoftAux heads, AuxConcat,
    Color prefixes); else None. A FUSED_TAIL net matches none
    (megastep.py:340-342). With ``for_mesh`` the flat-MLP family is
    skipped: it has no data-parallel kernel, and the deep family takes flat
    nets as zero-level specs. Without ``aux_data`` a net whose spec reads
    the aux input (``has_aux``) matches none (trainer.py:364-371)."""
    from . import megastep_deep as deep
    from . import megastep_mlp as mlp

    spec = spec_from_net(net)
    if spec is not None:
        return FusedPlan(spec, MEGA_LAYER_IDX, megastep_epoch, kernel_layout,
                         framework_layout)
    mspec = None if for_mesh else mlp.mlp_spec_from_net(net)
    if mspec is not None:
        return FusedPlan(mspec, mlp.MLP_LAYER_IDX, mlp.mlp_epoch,
                         mlp.kernel_layout_mlp, mlp.framework_layout_mlp)
    dspec = deep.deep_spec_from_net(net)
    if dspec is not None and (aux_data or not dspec.has_aux):
        return FusedPlan(dspec, deep.deep_layer_idx(net), deep.deep_epoch,
                         deep.kernel_layout_deep, deep.framework_layout_deep)
    return None


AUX_DATA_REASON = ("aux-input nets (SoftAux head / AuxConcat tail) need "
                   "aux data (pass aux arrays to the Trainer)")


def fused_decline_reason(net, aux_data=True):
    """Why ``fused_plan(net, aux_data=aux_data)`` is None (None when a
    family matches). The deep family's grammar holds the others', so its
    matcher names the reason."""
    from . import megastep_deep as deep

    if fused_plan(net, aux_data=aux_data) is not None:
        return None
    return deep.deep_decline_reason(net) or AUX_DATA_REASON


# ------------------------------------------------------------------ layouts

def kernel_shapes(spec):
    """The 8 kernel-layout state shapes, in layout order."""
    return [
        (spec.maps1, spec.filt1 ** 2 * spec.in_ch), (spec.maps1, 1),
        (spec.maps2, spec.filt2 ** 2 * spec.maps1), (spec.maps2, 1),
        (spec.n_flat, spec.n_hid), (1, spec.n_hid),
        (spec.n_hid, spec.n_out), (1, spec.n_out),
    ]


def kernel_layout(allwts, spec):
    """Reference-layout tensors [[w1, b1], [w2, b2], [wh, bh], [wo, bo]] ->
    the 8 contiguous kernel-layout tensors."""
    (w1, b1), (w2, b2), (wh, bh), (wo, bo) = allwts
    F1, F2 = spec.filt1, spec.filt2
    out = [
        w1.permute(0, 2, 3, 1).reshape(spec.maps1, F1 * F1 * spec.in_ch),
        b1.reshape(spec.maps1, 1),
        w2.permute(0, 2, 3, 1).reshape(spec.maps2, F2 * F2 * spec.maps1),
        b2.reshape(spec.maps2, 1),
        wh, bh.reshape(1, spec.n_hid), wo, bo.reshape(1, spec.n_out),
    ]
    return [t.contiguous() for t in out]


def framework_layout(kparams, spec):
    """Inverse of kernel_layout."""
    w1, b1, w2, b2, wh, bh, wo, bo = kparams
    F1, F2 = spec.filt1, spec.filt2
    return [
        [w1.reshape(spec.maps1, F1, F1, spec.in_ch).permute(0, 3, 1, 2)
         .contiguous(), b1.reshape(spec.maps1)],
        [w2.reshape(spec.maps2, F2, F2, spec.maps1).permute(0, 3, 1, 2)
         .contiguous(), b2.reshape(spec.maps2)],
        [wh, bh.reshape(spec.n_hid)],
        [wo, bo.reshape(spec.n_out)],
    ]


# -------------------------------------------------------------------- noise

def db_lanes(spec):
    """Dropout words per sample and step: the final hidden's width plus the
    pre-hidden widths, plus one when an AuxConcat layer draws its convex
    mix (megastep.py:218-227). That draw reads lane 0, and the pre-hiddens
    then start at lane 1: pre-hidden j reads lanes [off_j, off_j +
    width_j); the final hidden reads the last n_hid. A SoftAux head's mix
    reads lane 0 of its n_hid lanes."""
    return (spec.n_hid + sum(ph[0] for ph in getattr(spec, "pre_hidden", ()))
            + (1 if getattr(spec, "aux_concat", ()) else 0))


def head_loss_tag(loss):
    """(tag, log_thresh) of a Softmax head's loss in the fused heads, as
    the JAX package's ``head_loss_tag`` (megastep.py:230-250): 'nll',
    'nllsq', truncated 'nll<NN>' as 'nllT' clamped at log(NN/100), and an
    unparseable suffix as plain 'nll' (the per-layer path prints the
    notice); None for a loss the fused heads do not take (hinge_max)."""
    if loss == "nll":
        return ("nll", 0.0)
    if loss == "nllsq":
        return ("nllsq", 0.0)
    if loss.startswith("nll"):
        try:
            t = float(np.clip(int(loss[-2:]) / 100, 0, 1))
        except ValueError:
            return ("nll", 0.0)
        return ("nllT", float(np.log(t)) if t > 0 else -1e30)
    return None


def fb_lanes(spec):
    """Rows of field words per step: the elastic field's 4, and 4 more when
    a ColorLayer draws its 3 per-row factors from rows 4-6."""
    return 8 if getattr(spec, "color", False) else 4


def epoch_noise_bits(seed, epoch, spec, n_batches, device):
    """One epoch of injected randomness as int32 views of 32-bit words,
    drawn on ``device`` from a torch.Generator seeded by (seed, epoch):

      ub (nb, 1, 8)            affine scalars (translation, origin, zoom,
                               angle)
      fb (nb, fb_lanes, HW)    Box-Muller source words of the elastic field
                               (rows 0-3), ColorLayer factors (rows 4-6 at
                               columns c*B + b)
      pb (nb, C0*B, HW)        pflip uniforms
      db (nb, B, db_lanes)     dropout uniforms

    The same shapes and bit -> variable mapping as the JAX package's
    ``epoch_noise_bits`` (its fb is drawn (HW, lanes) and shipped
    transposed); the words themselves differ, since the generators differ.
    Any spec with ``batch``, ``hw``, ``in_ch`` and ``n_hid`` (and the deep
    family's ``color`` and ``pre_hidden``) works; the flagship's words for
    a seed do not change with the extra fields."""
    state = np.random.SeedSequence([int(seed), int(epoch)]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             generator=gen, device=device)

    B, HW, C0 = spec.batch, spec.hw, spec.in_ch
    return (words(n_batches, 1, 8), words(n_batches, fb_lanes(spec), HW),
            words(n_batches, C0 * B, HW), words(n_batches, B, db_lanes(spec)))


def _u01(bits):
    """int32 words -> uniform [0, 1) from the low 24 bits."""
    return (bits & MASK24).to(torch.float32) * INV24


# ------------------------------------------------------------- plain twin

def _act(z, kind, slope):
    if kind == "leaky":
        return torch.clamp(z, min=0.0) + torch.clamp(z, max=0.0) * slope
    if kind == "tanh":
        return torch.tanh(z)
    if kind == "scaled_tanh":
        return 1.7 * torch.tanh(z * (2.0 / 3.0))
    if kind == "sigmoid":
        return 1.0 / (1.0 + torch.exp(-z))
    if kind == "softplus":
        return torch.clamp(z, min=0.0) + torch.log(1.0 + torch.exp(-z.abs()))
    raise NotImplementedError("fused activation kind: " + kind)


def _dact(z, kind, slope):
    """d act / dz recomputed from the PRE-activation z."""
    if kind == "leaky":
        return torch.where(z > 0, 1.0, slope).to(z.dtype)
    if kind == "tanh":
        t = torch.tanh(z)
        return 1.0 - t * t
    if kind == "scaled_tanh":
        t = torch.tanh(z * (2.0 / 3.0))
        return (1.7 * 2.0 / 3.0) * (1.0 - t * t)
    if kind == "sigmoid":
        s = 1.0 / (1.0 + torch.exp(-z))
        return s * (1.0 - s)
    if kind == "softplus":
        return 1.0 / (1.0 + torch.exp(-z))
    raise NotImplementedError("fused activation kind: " + kind)


def smoothing_factors(spec, device):
    """(G_h, G_w) of the elastic field's Gaussian smoothing on ``device``
    (placeholders when there is no field)."""
    from .elastic import gaussian_band_matrices

    H = spec.img
    if not spec.magnitude:
        z = torch.zeros((H, H), dtype=torch.float32, device=device)
        return z, z
    gh, gw = gaussian_band_matrices(H, H, max(int(spec.sigma), 1))
    return (torch.as_tensor(gh, device=device),
            torch.as_tensor(gw, device=device))


def _smooth(gh, n, gw):
    """The separable Gaussian smoothing G_h @ n @ G_w^T of n (..., H, W),
    each sum taken k = 0, 1, ... with one f32 multiply and one f32 add a
    term: the order of the CUDA kernels' k_warp (csrc/stages.cuh). A
    library product may sum in another order, and the warp's last bits
    decide which resampled pixels, and so which pool windows, tie exactly.
    Every product is formed by one multiply, then the sums run in order."""
    p = gh[:, :, None] * n[..., None, :, :]        # [i, k, j] = gh[i,k] n[k,j]
    t = torch.zeros_like(n)
    for k in range(n.shape[-2]):
        t = t + p[..., k, :]
    q = t[..., :, None, :] * gw                    # [i, j, k] = t[i,k] gw[j,k]
    s = torch.zeros_like(n)
    for k in range(n.shape[-1]):
        s = s + q[..., k]
    return s


def warp_field(spec, ub, fb, gh, gw):
    """The step's shared warp target (ty, tx), each (HW,) f32, from its
    affine words ``ub`` (8,) and field words ``fb`` (4, HW)."""
    H, HW = spec.img, spec.hw
    q = torch.arange(HW, device=ub.device)
    ty = (q // H).to(torch.float32)
    tx = (q % H).to(torch.float32)
    u = 2.0 * _u01(ub) - 1.0
    if spec.translation:
        ty = ty + spec.translation * u[0]
        tx = tx + spec.translation * u[1]
    if spec.magnitude:
        u1a = ((fb[0] & MASK24).to(torch.float32) + 0.5) * INV24
        u2a = _u01(fb[1])
        u1b = ((fb[2] & MASK24).to(torch.float32) + 0.5) * INV24
        u2b = _u01(fb[3])
        n0 = spec.magnitude * (torch.sqrt(-2.0 * torch.log(u1a))
                               * torch.cos(2.0 * math.pi * u2a))
        n1 = spec.magnitude * (torch.sqrt(-2.0 * torch.log(u1b))
                               * torch.sin(2.0 * math.pi * u2b))
        ty = ty + _smooth(gh, n0.reshape(H, H), gw).reshape(HW)
        tx = tx + _smooth(gh, n1.reshape(H, H), gw).reshape(HW)
    if spec.zoom != 1 or spec.angle:
        oy = (0.5 + 0.25 * u[2]) * H
        ox = (0.5 + 0.25 * u[3]) * H
        ty = ty - oy
        tx = tx - ox
        if spec.zoom != 1:
            ty = ty * torch.exp(math.log(spec.zoom) * u[4])
            tx = tx * torch.exp(math.log(spec.zoom) * u[5])
        if spec.angle:
            th = spec.angle * math.pi / 180.0 * u[6]
            ct, st = torch.cos(th), torch.sin(th)
            ty, tx = ct * ty + st * tx, -st * ty + ct * tx
        ty = ty + oy
        tx = tx + ox
    hi = H - 1 - 0.001   # load-bearing: keeps the +1 bilinear taps in range
    return torch.clamp(ty, 0.0, hi), torch.clamp(tx, 0.0, hi)


def _pow01(x, g):
    """x**g for x in [0, 1] as exp(g log x), with x == 0 giving 0 exactly
    (megastep.py:1290-1294)."""
    return torch.where(x > 0.0,
                       torch.exp(g * torch.log(torch.clamp(x, min=1e-30))),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def color_rows(spec, x, cbits):
    """The ColorLayer train transform (color.py:37-43; megastep.py:
    1297-1311) on channel-major rows (c*B + b, HW): white balance
    exp(ln b * u), clip to [0, 1], gamma x**g1, inverse gamma 1-(1-x)**g2,
    with u = 2*U - 1 drawn per row from ``cbits`` (rows, 3)."""
    def pos_rand(col, a):
        u = 2.0 * _u01(cbits[:, col:col + 1]) - 1.0
        return torch.exp(math.log(a) * u)

    xm = x * (1.0 / spec.maxval)
    xm = torch.clamp(xm * pos_rand(0, spec.balance), 0.0, 1.0)
    xm = _pow01(xm, pos_rand(1, spec.gamma))
    xm = 1.0 - _pow01(1.0 - xm, pos_rand(2, spec.gamma))
    return xm * spec.maxval


def augment(spec, x, ub, fb, pb, gh, gw):
    """[Color ->] invert -> resample every row of ``x`` (C0*B, HW) at the
    step's one warp (nearest: floor(t+.5); bilinear: 4 taps) -> pflip. The
    color factors of row r come from field-word rows 4-6, column r."""
    H = spec.img
    if getattr(spec, "color", False):
        x = color_rows(spec, x, fb[4:7, :x.shape[0]].T)
    if spec.invert:
        x = 1.0 - x
    if warp_active(spec):
        ty, tx = warp_field(spec, ub, fb, gh, gw)
        if spec.nearest:
            idx = (torch.floor(ty + 0.5).long() * H
                   + torch.floor(tx + 0.5).long())
            x = x[:, idx]
        else:
            top, left = ty.long(), tx.long()    # trunc == floor here
            fy = ty - top.to(torch.float32)
            fx = tx - left.to(torch.float32)
            i00 = top * H + left
            x = (x[:, i00] * ((1.0 - fy) * (1.0 - fx))
                 + x[:, i00 + 1] * ((1.0 - fy) * fx)
                 + x[:, i00 + H] * (fy * (1.0 - fx))
                 + x[:, i00 + H + 1] * (fy * fx))
    if spec.pflip:
        x = torch.where(_u01(pb) < spec.pflip, 1.0 - x, x)
    return x


def _corr_weights(w_k, spec_f, maps_in):
    """Kernel-layout true-conv weights (M, F*F*Cin) -> the flipped
    cross-correlation weights (M, Cin*F*F) in F.unfold's patch order."""
    w = w_k.reshape(w_k.shape[0], spec_f, spec_f, maps_in).permute(0, 3, 1, 2)
    return torch.flip(w, (2, 3)).reshape(w_k.shape[0], -1)


def _padded(x, spec_f, pad, cstride, side):
    """``x`` (B, C, S, S) on the zero-padded canvas a conv level reads:
    ``pad`` zeros before each axis and as many after as the last of the
    ``side`` outputs at stride ``cstride`` reaches ((side-1)*cstride + F
    rows in all). A valid stride-1 level reads ``x`` itself."""
    hi = max(0, (side - 1) * cstride + spec_f - x.shape[2] - pad)
    if not (pad or hi):
        return x
    return F.pad(x, (pad, hi, pad, hi))


def _conv_true(x, w_k, spec_f, maps_in, pad=0, cstride=1, side=None):
    """True (flipped-filter) convolution with kernel-layout weights
    (M, F*F*Cin) on (B, Cin, S, S): output (y, x), for y, x < ``side``
    (default the valid stride-1 side), sums tap (u, v) of input row
    y*cstride + F-1-u - ``pad`` (and its column likewise), zeros outside
    the input: pad 0 is a valid conv, F-1 a 'full' one. Summed tap by tap
    in the kernel layout's order (u, v, c), each step one f32 multiply and
    one f32 add — the CUDA kernel sums in the same order without fused
    multiply-adds, and adds nothing for a tap off the input, which equals
    adding this zero product. The max-pool that follows sends its gradient
    to every exact tie, and which outputs tie exactly depends on the order
    of the sum (the +-1/sqrt(fan_in) init and the clipped, resampled
    pixels make such coincidences common), so the twin and the kernel share
    one order. A library convolution or GEMM may sum each output in another
    order."""
    if side is None:
        side = x.shape[2] - spec_f + 1
    x = _padded(x, spec_f, pad, cstride, side)
    M, span = w_k.shape[0], (side - 1) * cstride + 1
    z = torch.zeros((x.shape[0], M, side, side), dtype=x.dtype,
                    device=x.device)
    for u in range(spec_f):
        for v in range(spec_f):
            oy, ox = spec_f - 1 - u, spec_f - 1 - v
            for c in range(maps_in):
                w = w_k[:, (u * spec_f + v) * maps_in + c].reshape(1, M, 1, 1)
                z = z + w * x[:, c:c + 1, oy:oy + span:cstride,
                              ox:ox + span:cstride]
    return z


def _conv_true_dgrad(dz, w_k, spec_f, maps_in, side_in, pad=0, cstride=1):
    """d conv_true / d input: scatter each output's gradient back over its
    patch (the transpose of the patch matrix) on _padded's canvas, then
    crop the input's ``side_in`` square out of it."""
    side = dz.shape[2]
    dcols = _corr_weights(w_k, spec_f, maps_in).T @ dz.reshape(
        dz.shape[0], dz.shape[1], -1)
    hi = max(0, (side - 1) * cstride + spec_f - side_in - pad)
    canvas = pad + side_in + hi
    d = F.fold(dcols, (canvas, canvas), spec_f, stride=cstride)
    return d[:, :, pad:pad + side_in, pad:pad + side_in]


def _conv_true_wgrad(x, dz, spec_f, pad=0, cstride=1):
    """d conv_true / d w in kernel layout: dw[m, (u*F+v)*C + c] =
    sum_{b,y,x} dz[b,m,y,x] * x[b,c,y*cs+F-1-u-pad,x*cs+F-1-v-pad] (zero
    off the input). A patch matrix and one product (not a conv with a
    dz-sized filter, which a GPU library may run through FFT at a lower
    precision)."""
    B, M = dz.shape[0], dz.shape[1]
    x = _padded(x, spec_f, pad, cstride, dz.shape[2])
    cols = F.unfold(x, spec_f, stride=cstride)          # (B, C*F*F, L)
    dwc = torch.einsum("bml,bkl->mk", dz.reshape(B, M, -1), cols)
    dw = torch.flip(dwc.reshape(M, x.shape[1], spec_f, spec_f), (2, 3))
    return dw.permute(0, 2, 3, 1).reshape(M, -1)


def _pool(spec_pool, ib, h):
    r = pool_windows(h, spec_pool, ib)
    return r, r.amax(dim=(3, 5))


def step_reference(spec, x, y, ub, fb, pb, db, params, gh, gw):
    """One step of the fused kernel in plain PyTorch: augmentation, forward,
    hand-derived backward. ``x`` (C0*B, HW) channel-major rows, ``y`` (B,)
    int32, bits as in epoch_noise_bits (one step's slice). Returns
    (cost, minf, grads) with grads in kernel layout; params unchanged."""
    B, H, C0 = spec.batch, spec.img, spec.in_ch
    M1, M2 = spec.maps1, spec.maps2
    w1, b1, w2, b2, wh, bh, wo, bo = params

    a = augment(spec, x, ub, fb, pb, gh, gw)
    a = a.reshape(C0, B, H, H).transpose(0, 1)            # (B, C0, H, H)

    z1 = _conv_true(a, w1, spec.filt1, C0) + b1.reshape(1, M1, 1, 1)
    h1 = _act(z1, spec.act1, spec.slope1)
    r1, p1 = _pool(spec.pool1, spec.ib1, h1)
    z2 = _conv_true(p1, w2, spec.filt2, M1) + b2.reshape(1, M2, 1, 1)
    h2 = _act(z2, spec.act2, spec.slope2)
    r2, p2 = _pool(spec.pool2, spec.ib2, h2)
    f = p2.reshape(B, spec.n_flat)

    z3 = f @ wh + bh
    h3 = _act(z3, spec.act_h, spec.slope_h)
    if spec.pdrop:
        mask = (_u01(db) >= spec.pdrop).to(torch.float32)  # no rescale
        h3d = h3 * mask
    else:
        mask, h3d = None, h3
    z4 = h3d @ wo + bo
    cost, minf, dz4 = softmax_nll(z4, y, B)
    cost = cost + weight_cost(
        [(spec.reg1, (w1, b1)), (spec.reg2, (w2, b2)),
         (spec.reg_h, (wh, bh)), (spec.reg_o, (wo, bo))])

    # hand-derived backward
    dwo = h3d.T @ dz4
    dbo = dz4.sum(dim=0, keepdim=True)
    dh3 = dz4 @ wo.T
    if spec.pdrop:
        dh3 = dh3 * mask
    dz3 = dh3 * _dact(z3, spec.act_h, spec.slope_h)
    dwh = f.T @ dz3
    dbh = dz3.sum(dim=0, keepdim=True)
    df = dz3 @ wh.T

    dp2 = df.reshape(p2.shape)
    dz2 = (pool_backward(r2, p2, dp2, spec.c2)
           * _dact(z2, spec.act2, spec.slope2))
    dw2 = _conv_true_wgrad(p1, dz2, spec.filt2)
    db2 = dz2.sum(dim=(0, 2, 3)).reshape(M2, 1)
    dp1 = _conv_true_dgrad(dz2, w2, spec.filt2, M1, spec.p1)
    dz1 = (pool_backward(r1, p1, dp1, spec.c1)
           * _dact(z1, spec.act1, spec.slope1))
    dw1 = _conv_true_wgrad(a, dz1, spec.filt1)
    db1 = dz1.sum(dim=(0, 2, 3)).reshape(M1, 1)
    return cost, minf, (dw1, db1, dw2, db2, dwh, dbh, dwo, dbo)


def softmax_nll(z4, y, batch):
    """Softmax head, loss nll (megastep.py:1552-1557, 1681-1682): (mean
    NLL, min true-class log-prob, dL/dz4)."""
    zc = z4 - z4.amax(dim=1, keepdim=True)
    logp = zc - torch.log(torch.exp(zc).sum(dim=1, keepdim=True))
    onehot = F.one_hot(y.long(), z4.shape[1]).to(torch.float32)
    true_logp = (logp * onehot).sum(dim=1)
    dz4 = (torch.exp(logp) - onehot) * (1.0 / batch)
    return -true_logp.sum() / batch, true_logp.min(), dz4


LOGIT_EPS = 0.001


def centered_nll(spec, z4, y, centers):
    """CenteredOut head, loss nll, forward and backward (megastep.py:
    1568-1657): (mean NLL, min watchdog feature, dL/dz4, dL/dcenters or
    None). ``centers`` (n_classes, n_feats).

    LOGIT: sigmoid features squeezed into [eps, 1-eps] before the bit
    probabilities; the watchdog reads the raw sigmoid. RBF: squared
    distances by the expansion ||v||^2 - 2 v.c + ||c||^2, the junk column
    only in the partition sum. The watchdog feature is features[b, y] with
    y clamped to the feature width (n_classes may exceed it)."""
    B, NF = z4.shape
    yl = y.long()
    if spec.head == "logit":
        s = 1.0 / (1.0 + torch.exp(-z4))
        v = s * (1.0 - 2.0 * LOGIT_EPS) + LOGIT_EPS
        cy = centers[yl]                      # the true class's row
        bp = cy * v + (1.0 - cy) * (1.0 - v)
        true_logp = torch.log(bp).sum(dim=1)
        feats = s
        dv = (1.0 - 2.0 * cy) / (B * bp)
        dz4 = dv * (1.0 - 2.0 * LOGIT_EPS) * s * (1.0 - s)
        dcenters = None
    else:
        onehot = F.one_hot(yl, spec.n_classes).to(torch.float32)
        t = torch.tanh(z4 * (2.0 / 3.0))
        v = 1.7 * t
        d = ((v * v).sum(dim=1, keepdim=True) - 2.0 * (v @ centers.T)
             + (centers * centers).sum(dim=1)[None, :])
        zc = -d
        m = torch.clamp(zc.amax(dim=1, keepdim=True), min=-spec.junk_dist)
        lse = torch.log(torch.exp(zc - m).sum(dim=1, keepdim=True)
                        + torch.exp(-spec.junk_dist - m))
        logp = zc - m - lse
        true_logp = (logp * onehot).sum(dim=1)
        feats = v
        dd = -((torch.exp(logp) - onehot) * (1.0 / B))    # dL/d dists
        rs = dd.sum(dim=1, keepdim=True)
        dv = 2.0 * (v * rs - dd @ centers)
        dz4 = dv * 1.7 * (2.0 / 3.0) * (1.0 - t * t)
        dcenters = (2.0 * (centers * dd.sum(dim=0)[:, None] - dd.T @ v)
                    if spec.learn_centers else None)
    yc = torch.clamp(yl, max=NF - 1)
    minf = feats[torch.arange(B, device=z4.device), yc].min()
    return -true_logp.sum() / B, minf, dz4, dcenters


def weight_cost(groups):
    """L1/L2 weight cost of (LayerReg, tensors) groups (layer.py:109-117)."""
    cost = 0.0
    for reg, ts in groups:
        if reg.L1:
            cost = cost + reg.L1 * sum(t.abs().sum() for t in ts)
        if reg.L2:
            cost = cost + reg.L2 * sum((t * t).sum() for t in ts)
    return cost


def reg_kinds(spec):
    """(LayerReg, max-norm kind) per kernel-layout tensor: conv kernels are
    rows, dense weights columns, biases clip."""
    return [(spec.reg1, "rows"), (spec.reg1, "bias"),
            (spec.reg2, "rows"), (spec.reg2, "bias"),
            (spec.reg_h, "cols"), (spec.reg_h, "bias"),
            (spec.reg_o, "cols"), (spec.reg_o, "bias")]


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
    """Old-accumulator momentum + max-norm, in place (layer.py:82-103);
    ``kinds`` is the (LayerReg, max-norm kind) list of the state tensors."""
    for p, a, g, (reg, kind) in zip(params, moms, grads, kinds):
        if not reg.rate:
            continue
        if reg.L2:
            g = g + (2.0 * reg.L2) * p
        if reg.L1:
            g = g + reg.L1 * torch.sign(p)
        p_new = _maxnorm(p - (reg.rate * lr) * a, reg.maxnorm, kind)
        a.copy_(reg.momentum * a + (1.0 - reg.momentum) * g)
        p.copy_(p_new)


@torch.no_grad()
def megastep_epoch_reference(kparams, kmoms, x_steps, y_steps, bits, lr,
                             spec):
    """The plain PyTorch twin of the CUDA epoch kernel (and of the JAX
    package's ``_kernel``). ``x_steps`` (nb, C0*B, HW) f32 channel-major
    rows, ``y_steps`` (nb, B) int32, ``bits`` from epoch_noise_bits.
    Returns (kparams, kmoms, cost_minf (nb, 2)) as new tensors."""
    ub, fb, pb, db = bits
    nb = x_steps.shape[0]
    lr = torch.tensor(lr, dtype=torch.float32, device=x_steps.device)
    params = [t.clone() for t in kparams]
    moms = [t.clone() for t in kmoms]
    gh, gw = smoothing_factors(spec, x_steps.device)
    cm = torch.empty((nb, 2), dtype=torch.float32, device=x_steps.device)
    for s in range(nb):
        cost, minf, grads = step_reference(
            spec, x_steps[s], y_steps[s], ub[s, 0], fb[s], pb[s], db[s],
            params, gh, gw)
        cm[s, 0], cm[s, 1] = cost, minf
        apply_updates(reg_kinds(spec), params, moms, grads, lr)
    return params, moms, cm


# --------------------------------------------------------------- the kernel

def check_epoch_inputs(name, kparams, kmoms, x_steps, y_steps, bits, spec,
                       shapes):
    """Raise unless every tensor of an epoch call has the shape, dtype,
    device and contiguity its kernel reads; ``shapes`` are the state's."""
    nb = x_steps.shape[0]
    B, HW, C0 = spec.batch, spec.hw, spec.in_ch
    want = [(x_steps, (nb, C0 * B, HW), torch.float32),
            (y_steps, (nb, B), torch.int32),
            (bits[0], (nb, 1, 8), torch.int32),
            (bits[1], (nb, fb_lanes(spec), HW), torch.int32),
            (bits[2], (nb, C0 * B, HW), torch.int32),
            (bits[3], (nb, B, db_lanes(spec)), torch.int32)]
    if len(kparams) != len(shapes) or len(kmoms) != len(shapes):
        raise ValueError(f"{name} takes {len(shapes)} params and "
                         f"{len(shapes)} moms")
    want += [(t, s, torch.float32) for t, s in zip(kparams, shapes)]
    want += [(t, s, torch.float32) for t, s in zip(kmoms, shapes)]
    check_tensors(name, want)


def check_step_inputs(name, x, y, words, params, grads, cm, spec, shapes):
    """As check_epoch_inputs for one data-parallel step: ``x`` (C0*B, HW),
    ``y`` (B,), one step's words, the state, the flat gradient buffer and
    the (2,) cost_minf output."""
    B, HW, C0 = spec.batch, spec.hw, spec.in_ch
    if len(params) != len(shapes):
        raise ValueError(f"{name} takes {len(shapes)} params")
    want = [(x, (C0 * B, HW), torch.float32), (y, (B,), torch.int32),
            (words[0], (8,), torch.int32),
            (words[1], (fb_lanes(spec), HW), torch.int32),
            (words[2], (C0 * B, HW), torch.int32),
            (words[3], (B, db_lanes(spec)), torch.int32),
            (grads, (sum(r * c for r, c in shapes),), torch.float32),
            (cm, (2,), torch.float32)]
    want += [(t, s, torch.float32) for t, s in zip(params, shapes)]
    check_tensors(name, want)


def check_update_inputs(name, params, moms, grads, shapes):
    """As check_epoch_inputs for the update after the all-reduce."""
    if len(params) != len(shapes) or len(moms) != len(shapes):
        raise ValueError(f"{name} takes {len(shapes)} params and "
                         f"{len(shapes)} moms")
    want = [(grads, (sum(r * c for r, c in shapes),), torch.float32)]
    want += [(t, s, torch.float32) for t in (params, moms)
             for t, s in zip(t, shapes)]
    check_tensors(name, want)


def check_tensors(name, want):
    """Raise unless each (tensor, shape, dtype) of ``want`` matches and all
    lie contiguous on the first one's device."""
    dev = want[0][0].device
    for t, shape, dtype in want:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name}: got {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on "
                             f"{dev} (got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def megastep_epoch(kparams, kmoms, x_steps, y_steps, bits, lr, spec):
    """Train one epoch; same contract as megastep_epoch_reference.

    A CPU ``x_steps`` runs the plain twin. A CUDA ``x_steps`` launches the
    hand-written CUDA kernel (one C call per epoch; it loops the steps on
    the current stream) and counts the launch in
    ``megastep_epoch.launches``; any other device raises."""
    if x_steps.device.type == "cpu":
        return megastep_epoch_reference(kparams, kmoms, x_steps, y_steps,
                                        bits, lr, spec)
    if x_steps.device.type != "cuda":
        raise ValueError(f"megastep_epoch: no kernel for {x_steps.device}")
    check_epoch_inputs("megastep_epoch", kparams, kmoms, x_steps, y_steps,
                       bits, spec, kernel_shapes(spec))
    from . import _build

    params = [t.clone() for t in kparams]   # updated in place by the kernel
    moms = [t.clone() for t in kmoms]
    cm = torch.empty((x_steps.shape[0], 2), dtype=torch.float32,
                     device=x_steps.device)
    gh, gw = smoothing_factors(spec, x_steps.device)
    _build.megastep_launch(spec, x_steps, y_steps, bits, gh, gw, params,
                           moms, cm, float(lr))
    megastep_epoch.launches += 1
    return params, moms, cm


megastep_epoch.launches = 0


# ------------------------------------------------- the data-parallel step

def split_grads(grads, shapes):
    """Views of the flat gradient buffer, one per state tensor of
    ``shapes``, in layout order."""
    out, o = [], 0
    for r, c in shapes:
        out.append(grads[o:o + r * c].view(r, c))
        o += r * c
    return out


def step_constants(spec, device):
    """The constant tensors a flagship step reads on ``device``: the warp's
    smoothing factors (gh, gw). Made once per epoch, not per step: each is
    a host-to-device copy."""
    return smoothing_factors(spec, device)


@torch.no_grad()
def megastep_grad_step_reference(spec, consts, x, y, words, params, grads,
                                 cm):
    """The plain PyTorch version of one data-parallel step's gradient at the
    flagship (the JAX package's ``_kernel_grad`` through ``_conv_fwd_bwd``):
    step_reference at ``spec`` (the per-rank batch) on ``x`` (C0*B, HW) and
    ``y`` (B,) with one step's words (ub (8,), fb, pb, db) and
    step_constants ``consts``, writing the data gradients of the 8 state
    tensors back to back into ``grads`` and (cost, minf) into ``cm`` (2,).
    Parameters are read only."""
    gh, gw = consts
    cost, minf, g = step_reference(spec, x, y, *words, params, gh, gw)
    grads.copy_(torch.cat([t.reshape(-1) for t in g]))
    cm[0], cm[1] = cost, minf


def megastep_grad_step(spec, consts, x, y, words, params, grads, cm):
    """One step's gradient; same contract as megastep_grad_step_reference.

    CPU tensors run the plain version. CUDA tensors launch
    ``megastep_grad_step`` of csrc/megastep.cu (one C call: the epoch
    kernel's stages up to the last weight gradient) and count the launch
    in ``megastep_grad_step.launches``; any other device raises."""
    if x.device.type == "cpu":
        return megastep_grad_step_reference(spec, consts, x, y, words, params,
                                            grads, cm)
    if x.device.type != "cuda":
        raise ValueError(f"megastep_grad_step: no kernel for {x.device}")
    check_step_inputs("megastep_grad_step", x, y, words, params, grads, cm,
                      spec, kernel_shapes(spec))
    from . import _build

    _build.megastep_grad_launch(spec, x, y, words, *consts, params, grads,
                                cm)
    megastep_grad_step.launches += 1


megastep_grad_step.launches = 0


@torch.no_grad()
def megastep_update_reference(spec, params, moms, grads, lr):
    """The plain update after the gradient all-reduce: apply_updates of the
    flat ``grads`` to ``params`` and ``moms``, in place, at the f32 ``lr``
    the epoch twin uses."""
    apply_updates(reg_kinds(spec), params, moms,
                  split_grads(grads, kernel_shapes(spec)),
                  torch.tensor(lr, dtype=torch.float32, device=grads.device))


def megastep_update(spec, params, moms, grads, lr):
    """The update after the all-reduce; same contract as
    megastep_update_reference. CPU tensors run the plain version; CUDA
    tensors launch ``megastep_update`` of csrc/megastep.cu (k_update and
    the max-norm kernels of the epoch) and count it in
    ``megastep_update.launches``; any other device raises."""
    if grads.device.type == "cpu":
        return megastep_update_reference(spec, params, moms, grads, lr)
    if grads.device.type != "cuda":
        raise ValueError(f"megastep_update: no kernel for {grads.device}")
    check_update_inputs("megastep_update", params, moms, grads,
                        kernel_shapes(spec))
    from . import _build

    _build.megastep_update_launch(spec, params, moms, grads, float(lr))
    megastep_update.launches += 1


megastep_update.launches = 0

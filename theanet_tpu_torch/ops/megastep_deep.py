"""Whole-epoch fused training of conv stacks of any depth and of flat nets.

Port of ``theanet_tpu/ops/megastep_deep.py``. One call trains a whole epoch
of ``[Color ->] Input/Elastic -> (Conv -> [Pool])*n -> (Hidden ->
[DropOut])*m -> Head`` for n >= 0 and m >= 1: per step, the color jitter
and elastic augmentation from injected bits, the forward pass, the
hand-derived backward, L1/L2 gradients and the old-accumulator momentum +
max-norm update of every state tensor.

  * ``deep_epoch_reference`` is the plain PyTorch twin (of the JAX
    package's ``_kernel_deep`` and of the CUDA kernel): the specification
    the kernel is held to, and what CPU tensors run.
  * ``deep_epoch`` is the wrapper: CPU tensors go to the twin; CUDA tensors
    launch ``csrc/megastep_deep.cu`` (one C call per epoch) or raise. It
    counts its kernel launches in ``deep_epoch.launches``.

The grammar the port takes is the JAX family's: convs in every geometry
the JAX family fuses ('valid' at any stride that divides in-F+1, 'same',
and stride-1 'full' where the level's pool washes out the reference's
in+F+1 booking; see ``DeepSpec.levels``), each followed by a PoolLayer of
any size (with or without ignore_border) or by none (the identity pool); an
optional MeanLayer after the conv stack (the flatten is then the per-map
mean of the last pooled level: each position times 1/pn^2, summed in
row-major order; its gradient df/pn^2 at every position); an optional
AuxConcatLayer (its frozen LocationInfo encoder appends its output to the
flatten); Hidden layers each with an optional DropOutLayer, whose rate
folds into the layer's as 1-(1-p1)(1-p2); a Softmax head (loss 'nll',
'nllsq' or truncated 'nll<NN>'), a Hinge or an ExpLoss head, or a
CenteredOut(nll) head, LOGIT (frozen centers) or RBF (learned or frozen
centers); or, directly on the conv features, a SoftAux(nll) head. A net
with an aux layer reads a (B, 4) aux row block a step (``aux_steps`` (nb,
B, 4)). The bare 2-conv Softmax(nll) pattern stays with the flagship
family when its matcher takes it, and the bare flat Input/Elastic ->
Hidden -> Softmax(nll) pattern with the flat-MLP family (``fused_plan``
tries flagship, MLP, deep). The TPU's grouped lane-slot layout has no
counterpart. A spec is taken by the route rule (``megastep.route_reason``):
the JAX package's VMEM model (``route.deep_jax_reason``) admits it, or its
head fits the shared memory a block can opt in to; a head beyond the
opt-in keeps its scratch in the workspace (csrc/megastep_deep.cu
step_setup). A warp field beyond a block's shared memory is declined by
name. Every family runs a reference batch whole, as one step at B =
BATCH_SZ (the JAX package tiles only in its flagship, and this package not
at all).

An even 'same' filter reads the port's per-layer path's taps (a full conv
cropped at (F-1)//2, as the reference's convpool.py does). The JAX
package's kernel reads them one row and one column lower than its own
per-layer path, so for even filters the twin follows the JAX per-layer
step, and for odd filters, where the two agree, the JAX kernel too.

Kernel-layout state, per conv level the weights (M, F*F*Cin) indexed
(u*F+v)*Cin + c and the bias column (M, 1); per dense layer the weights
(in, out) and the bias row (1, out); learned RBF centers last. A SoftAux
head's eight tensors follow the convs: [Wt, bt, w1a, b1a, w2a, b2a, cw, cb],
biases as rows. The AuxConcat encoder is a constant, not state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .megastep import (LayerReg, _act, _conv_true, _conv_true_dgrad,
                       _conv_true_wgrad, _dact, _pool, _u01, act_of, aug_of,
                       apply_updates, augment, centered_nll,
                       check_epoch_inputs, check_step_inputs, check_tensors,
                       check_update_inputs, head_loss_tag,
                       flagship_route_reason, flagship_spec, reg_of,
                       route_reason, smoothing_factors, spec_from_net,
                       split_grads, weight_cost)
from . import route
from ..layers.conv import pool_backward

__all__ = ["DeepSpec", "deep_spec_from_net", "deep_decline_reason",
           "deep_layer_idx", "deep_kernel_shapes", "deep_reg_kinds",
           "deep_head_smem", "deep_route_reason",
           "kernel_layout_deep", "framework_layout_deep",
           "aux_concat_weights", "head_loss",
           "deep_epoch_reference", "deep_epoch",
           "deep_step_constants", "deep_grad_step_reference",
           "deep_grad_step",
           "deep_update_reference", "deep_update"]

class DeepSpec(NamedTuple):
    """The JAX DeepSpec's fields for the port's grammar, without the TPU
    layout fields (group_g, exact_movement)."""
    batch: int
    img: int            # input H = W
    filts: tuple        # filter size per conv level
    pools: tuple        # pool window/stride per level (1: no PoolLayer)
    ibs: tuple          # PoolLayer ignore_border per level
    maps: tuple         # output maps per conv level
    slopes: tuple       # conv activation slope per level (see act_of)
    n_hid: int          # the final hidden layer's width
    n_out: int          # head width: classes (softmax) or features
    slope_h: float
    pdrop: float        # the final hidden's dropout, DropOut folded in
    translation: float
    zoom: float
    magnitude: float
    sigma: int
    pflip: float
    angle: float
    invert: bool
    nearest: bool
    regs: tuple         # LayerReg per conv level
    reg_h: LayerReg
    reg_o: LayerReg
    in_ch: int = 1
    head: str = "softmax"        # 'softmax' | 'logit' | 'rbf'
    n_classes: int = 0
    junk_dist: float = 0.0       # RBF junk column, inf clamped to 1e30
    learn_centers: bool = False
    centers_bytes: bytes = b""   # frozen centers (f32 row-major)
    color: bool = False          # a ColorLayer that is not the identity
    balance: float = 1.0
    gamma: float = 1.0
    maxval: float = 1.0
    acts: tuple = ()             # activation kind per conv level
    act_h: str = "leaky"
    # hidden layers before the final one: (width, act kind, slope, pdrop)
    pre_hidden: tuple = ()
    regs_pre: tuple = ()
    # SoftAux head (head 'softaux'): the encoder's (hidden, out) widths;
    # ``boost`` scales the aux mix (SoftAux's or AuxConcat's)
    n_aux: tuple = ()
    boost: float = 1.0
    # a softmax-kind head's loss: 'nll' | 'nllsq' | 'nllT' (clamped at
    # log_thresh) | 'hinge' (HingeLayer) | 'exp' (ExpLossLayer)
    loss: str = "nll"
    log_thresh: float = 0.0
    # AuxConcatLayer after the flatten: the encoder's (hidden, out) widths
    # and its frozen weights w1 (2, nah), b1, w2 (nah, nao), b2 (f32)
    aux_concat: tuple = ()
    aux_wts_bytes: bytes = b""
    # the conv geometry: per level the conv stride and the border mode
    # ('valid' | 'same' | 'full'); empty means all stride-1 valid. A
    # MeanLayer after the conv stack makes the flatten the per-map mean of
    # the last pooled level (n_flat = maps[-1]).
    conv_strides: tuple = ()
    modes: tuple = ()
    mean_tail: bool = False

    def cstride(self, k):
        return self.conv_strides[k] if self.conv_strides else 1

    def mode(self, k):
        return self.modes[k] if self.modes else "valid"

    @property
    def has_aux(self):
        return self.head == "softaux" or bool(self.aux_concat)

    @property
    def n_tail_in(self):
        """The dense tail's input width: the flatten, plus the AuxConcat
        encoder's output."""
        return self.n_flat + (self.aux_concat[-1] if self.aux_concat else 0)

    @property
    def hw(self):
        return self.img * self.img

    @property
    def n_levels(self):
        return len(self.filts)

    @property
    def levels(self):
        """Per level (input side, pad, conv stride, conv side, pooled
        side): conv output (y, x) reads input row y*stride + F-1-u - pad
        for tap u (zeros off the input). 'valid' pads 0 and keeps
        (in-F+1)//stride outputs; 'same' pads F//2, the port's per-layer
        full conv cropped at (F-1)//2, and keeps in; 'full' pads F-1 and
        keeps in+F-1, the real tensor (the reference books in+F+1, which
        the matcher lets through only where the pool washes it out)."""
        out, s = [], self.img
        for k, (f, p, ib) in enumerate(zip(self.filts, self.pools,
                                           self.ibs)):
            mode, cs = self.mode(k), self.cstride(k)
            # zeros before the input, and on both sides together
            pad, both = {"valid": (0, 0), "same": (f // 2, f - 1),
                         "full": (f - 1, 2 * (f - 1))}[mode]
            c = (s + both - f + 1) // cs
            po = c // p if ib else -(-c // p)
            out.append((s, pad, cs, c, po))
            s = po
        return tuple(out)

    @property
    def sides(self):
        """The JAX package's per-level (lane grid side, conv side, pooled
        side): the grid is the input side, or for a 'full' level the side
        of the zero-padded grid its kernel works on, in + 2(F-1)."""
        return tuple((s + 2 * (f - 1) if self.mode(k) == "full" else s, c,
                      po)
                     for k, ((s, _, _, c, po), f) in enumerate(
                         zip(self.levels, self.filts)))

    @property
    def n_flat(self):
        if not self.maps:
            return self.in_ch * self.hw
        if self.mean_tail:
            return self.maps[-1]
        return self.maps[-1] * self.levels[-1][4] ** 2


# ----------------------------------------------------------------- matcher

_HEADS_TAKEN = ("SoftmaxLayer", "HingeLayer", "ExpLossLayer",
                "CenteredOutLayer", "SoftAuxLayer")


def _head_reason(head):
    """Decline reason of a head layer the port's deep family does not take
    (None when it takes it)."""
    name = type(head).__name__
    if name not in _HEADS_TAKEN:
        return f"the last layer {name} is not an output head"
    if name == "SoftmaxLayer" and head_loss_tag(head.loss) is None:
        return (f"head loss {head.loss!r}: the fused Softmax heads take "
                "'nll', 'nllsq' and 'nll<NN>' (the per-layer path trains "
                "the others, as in the JAX package)")
    if name in ("CenteredOutLayer", "SoftAuxLayer") and head.loss != "nll":
        return (f"{name} loss {head.loss!r}: the fused head is derived for "
                "'nll'")
    return None


def _head_cfg(head):
    """The DeepSpec fields of a dense-tail head."""
    name = type(head).__name__
    if name == "CenteredOutLayer":
        cfg = dict(head=head.kind.lower(), n_classes=head.n_classes,
                   junk_dist=min(float(head.junk_dist), 1e30),
                   learn_centers=bool(head.learn_centers))
        if not head.learn_centers:
            cfg["centers_bytes"] = np.ascontiguousarray(
                head.centers_init, np.float32).tobytes()
        return cfg
    if name == "SoftmaxLayer":
        tag, thresh = head_loss_tag(head.loss)
        return dict(head="softmax", n_classes=head.n_out, loss=tag,
                    log_thresh=thresh)
    return dict(head="softmax", n_classes=head.n_out,
                loss="hinge" if name == "HingeLayer" else "exp")


def _match(net):
    """(DeepSpec, None) when ``net`` is in the port's deep grammar and the
    route rule takes it; (DeepSpec, reason) when the route rule declines
    it; else (None, reason). The one copy of the family's eligibility
    rules: it takes what the JAX package's ``deep_spec_from_net`` takes
    (megastep_deep.py:380-535) and declines what it declines."""
    from ..layers import (AuxConcatLayer, ColorLayer, ConvLayer,
                          DropOutLayer, ElasticLayer, HiddenLayer,
                          InputLayer, MeanLayer, PoolLayer, SoftAuxLayer)

    from .megastep import FUSED_TAIL_REASON

    L = net.net_layers
    if net.fused_tail:
        return None, FUSED_TAIL_REASON
    reason = _head_reason(L[-1])
    if reason:
        return None, reason
    for k, lyr in enumerate(L):
        name = type(lyr).__name__
        if type(lyr) is ConvLayer:
            reason = _geometry_reason(k, lyr, L[k + 1] if k + 1 < len(L)
                                      else None)
            if reason:
                return None, reason
        actvn = getattr(lyr, "actvn", None)
        if (actvn is not None and act_of(actvn) is None
                and type(lyr).__name__ not in _HEADS_TAKEN):
            return None, (f"layer {k} activation {actvn!r} is outside the "
                          "fused registry")
        reg = getattr(lyr, "reg", None)
        if isinstance(reg, dict) and not reg["rate"]:
            return None, (f"layer {k} {name} is frozen (rate 0); the fused "
                          "layouts carry momentum for every owned layer")
    grammar = ("the layer pattern is outside the fused grammar ([Color ->] "
               "Input/Elastic -> (Conv -> [Pool])*n -> [Mean ->] "
               "[AuxConcat ->] (Hidden -> [DropOut])*m -> Softmax/Hinge/"
               "ExpLoss/CenteredOut, m >= 1; or (Conv -> [Pool])*n -> "
               "[Mean ->] SoftAux, n >= 1; Mean needs n >= 1)")

    i, color = 0, dict(color=False)
    if type(L[0]) is ColorLayer:
        cl = L[0]
        if not cl.identity:
            if cl.num_maps * net.batch_sz > cl.out_sz ** 2:
                return None, ("the ColorLayer's draws ride in the field "
                              "words' columns: num_maps x BATCH_SZ must be "
                              "at most img_sz^2")
            color = dict(color=True, balance=float(cl.balance),
                         gamma=float(cl.gamma), maxval=float(cl.maxval))
        i = 2 if len(L) > 1 and type(L[1]) is ElasticLayer else 1
    elif type(L[0]) in (InputLayer, ElasticLayer):
        i = 1
    aug_src = L[i - 1]

    convs, pools = [], []
    while i < len(L) and type(L[i]) is ConvLayer:
        convs.append(L[i])
        i += 1
        if i < len(L) and type(L[i]) is PoolLayer:
            pools.append((L[i].pool_sz, bool(L[i].ignore_border)))
            i += 1
        else:
            pools.append((1, False))      # no PoolLayer: the identity pool
    n = len(convs)
    mean_tail = bool(n and i < len(L) and type(L[i]) is MeanLayer)
    i += mean_tail
    aux_cfg = {}
    if i < len(L) and type(L[i]) is AuxConcatLayer:
        ac = L[i]
        aux_cfg = dict(aux_concat=tuple(ac.n_aux), boost=float(ac.boost),
                       aux_wts_bytes=b"".join(
                           np.ascontiguousarray(p, np.float32).tobytes()
                           for p in ac.params_init))
        i += 1
    in_ch = L[0].num_maps
    if n and convs[0].num_prev_maps != in_ch:
        return None, "the first conv's input maps differ from the input's"
    conv_acts = [act_of(c.actvn) for c in convs]
    common = dict(
        batch=net.batch_sz, img=L[0].out_sz,
        filts=tuple(c.filter_sz for c in convs),
        pools=tuple(p for p, _ in pools), ibs=tuple(ib for _, ib in pools),
        maps=tuple(c.num_maps for c in convs),
        conv_strides=tuple(c.stride for c in convs),
        modes=tuple(c.mode for c in convs), mean_tail=mean_tail,
        slopes=tuple(s for _, s in conv_acts),
        acts=tuple(k for k, _ in conv_acts), **aug_of(aug_src),
        regs=tuple(reg_of(c) for c in convs), in_ch=in_ch, **color)

    if type(L[-1]) is SoftAuxLayer:
        # the SoftAux head sits directly on the conv features; its linear
        # hidden plays the tail's hidden role (megastep_deep.py:412-447)
        head = L[-1]
        if not n or i != len(L) - 1:
            return None, grammar
        if aux_cfg:
            return None, ("an AuxConcatLayer feeding a SoftAux head: the "
                          "fused family takes one aux consumer, as in the "
                          "JAX package")
        spec = DeepSpec(n_hid=head.n_out, n_out=head.n_out, slope_h=1.0,
                        pdrop=0.0, reg_h=reg_of(head), reg_o=reg_of(head),
                        head="softaux", n_classes=head.n_out,
                        n_aux=tuple(head.n_aux), boost=float(head.boost),
                        **common)
    else:
        hid_groups = []
        while i < len(L) and type(L[i]) is HiddenLayer:
            h, pd = L[i], 0.0
            i += 1
            if i < len(L) and type(L[i]) is DropOutLayer:
                pd = float(L[i].pdrop)
                i += 1
            hid_groups.append((h, 1.0 - (1.0 - float(h.pdrop))
                               * (1.0 - pd)))
        if not hid_groups or i != len(L) - 1:
            return None, grammar
        head = L[i]
        hid, pdrop = hid_groups[-1]
        if spec_from_net(net) is not None:   # as megastep_deep.py:480-493
            return None, "the 2-conv Softmax pattern is the flagship family's"
        act_h = act_of(hid.actvn)
        pre = tuple((h.n_out, *act_of(h.actvn), pd)
                    for h, pd in hid_groups[:-1])
        spec = DeepSpec(
            n_hid=hid.n_out, n_out=head.n_out, slope_h=act_h[1],
            act_h=act_h[0], pdrop=pdrop, reg_h=reg_of(hid),
            reg_o=reg_of(head), pre_hidden=pre,
            regs_pre=tuple(reg_of(h) for h, _ in hid_groups[:-1]),
            **_head_cfg(head), **aux_cfg, **common)
    if any(c <= 0 or po <= 0 for _, c, po in spec.sides):
        return None, "the image is too small for the conv/pool levels"
    reason = deep_route_reason(spec)
    fspec = flagship_spec(net) if reason else None
    if fspec is not None:
        reason += ("; the flagship family declines it too: "
                   + flagship_route_reason(fspec))
    return spec, reason


def _geometry_reason(k, conv, after):
    """Why the fused family declines conv layer ``k`` (followed by layer
    ``after``) for its geometry, else None: the JAX package's rules
    (``_conv_stack_ok``, megastep_deep.py:270-313), its reasons
    (megastep.py:627-659). The reference books a 'full' conv's output as
    in+F+1 and a strided one's as (in-F+1)//stride; where that booking
    disagrees with the real tensor downstream, the reference's net
    shape-errors, and both packages keep such nets per layer."""
    from ..layers import PoolLayer

    f, s = conv.filter_sz, conv.in_sz
    if conv.mode == "full":
        if conv.stride > 1:
            return (f"layer {k} ConvLayer mode='full' with stride="
                    f"{conv.stride}: the reference strides the real in+F-1 "
                    "tensor while booking (in+F+1)//stride, so strided "
                    "'full' convs stay per layer, as in the JAX package")
        pool = after if type(after) is PoolLayer else None
        psz = pool.pool_sz if pool else 1
        ib = bool(pool.ignore_border) if pool else False
        real, booked = s + f - 1, s + f + 1
        pr, pb = ((real // psz, booked // psz) if ib
                  else (-(-real // psz), -(-booked // psz)))
        if pr != pb:
            return (f"layer {k} ConvLayer mode='full': the pool does not "
                    f"wash the reference's out=in+filter+1 booking back "
                    f"onto the real in+filter-1 tensor (pooled {pr} real "
                    f"against {pb} booked; such nets shape-error at the "
                    "flatten, and stay per layer, as in the JAX package)")
    if conv.stride > 1 and (s - f + 1) % conv.stride:
        return (f"layer {k} ConvLayer stride={conv.stride} does not divide "
                f"in-filter+1={s - f + 1} (the reference's floor out_sz "
                "booking disagrees with the strided tensor; such nets "
                "shape-error, and stay per layer, as in the JAX package)")
    return None


def deep_head_smem(spec):
    """csrc/megastep_deep.cu ``head_smem``: the head stage's scratch, (2 B
    NO + B NC + NC + 4 B) floats, NO the head's width and NC its classes;
    shared memory up to the opt-in, else a workspace region."""
    return 4 * (2 * spec.batch * spec.n_out + spec.batch * spec.n_classes
                + spec.n_classes + 4 * spec.batch)


def deep_route_reason(spec):
    """Why the deep family declines ``spec`` by the route rule or the warp
    launch limit (``megastep.route_reason``), else None."""
    return route_reason(spec, route.deep_jax_reason(spec),
                        deep_head_smem(spec),
                        "csrc/megastep_deep.cu head_smem")


def deep_spec_from_net(net):
    """A DeepSpec when ``net`` is in the port's deep grammar and the route
    rule takes it, else None."""
    spec, reason = _match(net)
    return None if reason else spec


def deep_decline_reason(net):
    """Why ``deep_spec_from_net(net)`` is None (None when it matches)."""
    return _match(net)[1]


def deep_layer_idx(net):
    """Net-layer indices of the parameterized layers of a matched net: the
    convs, the hiddens and the head (heads are HiddenLayer subclasses)."""
    from ..layers import ConvLayer, HiddenLayer

    return tuple(i for i, lyr in enumerate(net.net_layers)
                 if isinstance(lyr, (ConvLayer, HiddenLayer)))


# ------------------------------------------------------------------ layouts

def deep_kernel_shapes(spec):
    """The kernel-layout state shapes, in layout order."""
    shapes, prev = [], spec.in_ch
    for F_, m in zip(spec.filts, spec.maps):
        shapes += [(m, F_ * F_ * prev), (m, 1)]
        prev = m
    if spec.head == "softaux":
        nah, nao = spec.n_aux
        return shapes + [(spec.n_flat, spec.n_out), (1, spec.n_out),
                         (2, nah), (1, nah), (nah, nao), (1, nao),
                         (nao, spec.n_out), (1, spec.n_out)]
    prev = spec.n_tail_in
    for nh in (ph[0] for ph in spec.pre_hidden):
        shapes += [(prev, nh), (1, nh)]
        prev = nh
    shapes += [(prev, spec.n_hid), (1, spec.n_hid),
               (spec.n_hid, spec.n_out), (1, spec.n_out)]
    if spec.learn_centers:
        shapes.append((spec.n_classes, spec.n_out))
    return shapes


def deep_reg_kinds(spec):
    """(LayerReg, max-norm kind) per kernel-layout tensor: conv kernels are
    rows, dense weights and centers columns, biases clip. A SoftAux head's
    eight tensors share its one LayerReg."""
    out = []
    for reg in spec.regs:
        out += [(reg, "rows"), (reg, "bias")]
    if spec.head == "softaux":
        return out + [(spec.reg_o, "cols"), (spec.reg_o, "bias")] * 4
    for reg in spec.regs_pre + (spec.reg_h, spec.reg_o):
        out += [(reg, "cols"), (reg, "bias")]
    if spec.learn_centers:
        out.append((spec.reg_o, "cols"))
    return out


def kernel_layout_deep(allwts, spec):
    """Reference-layout tensors of the owned layers (convs, hiddens, head)
    -> the contiguous kernel-layout state. A frozen-centers head's third
    tensor stays out of the state."""
    out, prev = [], spec.in_ch
    for k, (F_, m) in enumerate(zip(spec.filts, spec.maps)):
        w, b = allwts[k][0], allwts[k][1]
        out += [w.permute(0, 2, 3, 1).reshape(m, F_ * F_ * prev),
                b.reshape(m, 1)]
        prev = m
    for lw in allwts[spec.n_levels:]:
        # weight, bias pairs: one for a dense layer, four for SoftAux
        n_pairs = 4 if spec.head == "softaux" else 1
        for j in range(n_pairs):
            out += [lw[2 * j], lw[2 * j + 1].reshape(1, -1)]
    if spec.learn_centers:
        out.append(allwts[-1][2])
    return [t.contiguous() for t in out]


def framework_layout_deep(kparams, spec):
    """Inverse of kernel_layout_deep: one [w, b(, centers)] list per owned
    layer, the SoftAux head's eight tensors in one."""
    out, prev = [], spec.in_ch
    for k, (F_, m) in enumerate(zip(spec.filts, spec.maps)):
        w = kparams[2 * k].reshape(m, F_, F_, prev).permute(0, 3, 1, 2)
        out.append([w.contiguous(), kparams[2 * k + 1].reshape(m)])
        prev = m
    j = 2 * spec.n_levels
    if spec.head == "softaux":
        return out + [[t if i % 2 == 0 else t.reshape(-1)
                       for i, t in enumerate(kparams[j:j + 8])]]
    while j + 1 < len(kparams):
        out.append([kparams[j], kparams[j + 1].reshape(-1)])
        j += 2
    if spec.learn_centers:
        out[-1].append(kparams[-1])
    return out


def frozen_centers(spec, device):
    """The frozen CenteredOut centers (n_classes, n_feats) on ``device``, or
    None when the head has none (softmax, learned centers)."""
    if spec.head in ("softmax", "softaux") or spec.learn_centers:
        return None
    c = np.frombuffer(spec.centers_bytes, np.float32).reshape(
        spec.n_classes, spec.n_out)
    return torch.as_tensor(c.copy(), device=device)


def aux_concat_weights(spec, device):
    """The AuxConcat encoder's frozen weights, packed w1 (2, nah), b1, w2
    (nah, nao), b2 in one flat f32 tensor on ``device`` (the kernel's
    constant), or None without an AuxConcat layer."""
    if not spec.aux_concat:
        return None
    return torch.as_tensor(np.frombuffer(spec.aux_wts_bytes,
                                         np.float32).copy(), device=device)


def _unpack_aux_weights(spec, flat):
    """(w1, b1, w2, b2) views of aux_concat_weights, biases as rows."""
    nah, nao = spec.aux_concat
    o1, o2, o3 = 2 * nah, 3 * nah, 3 * nah + nah * nao
    return (flat[:o1].view(2, nah), flat[o1:o2].view(1, nah),
            flat[o2:o3].view(nah, nao), flat[o3:].view(1, nao))


# ------------------------------------------------------------- plain twin

def head_loss(spec, z4, y, batch):
    """A softmax-kind head's loss (``spec.loss``) on the scores ``z4``,
    forward and hand-derived backward (megastep.py:1513-1563, 1660-1686):
    (cost, minf, dL/dz4). minf is the smallest true-class log-probability,
    or for 'hinge' and 'exp' the smallest true-class score (raw, or
    row-centred)."""
    NC = z4.shape[1]
    onehot = F.one_hot(y.long(), NC).to(torch.float32)
    if spec.loss == "hinge":
        # the mean over the whole (B, NC) matrix, the true class included
        true_s = (z4 * onehot).sum(dim=1, keepdim=True)
        marg = z4 + 1.0 - true_s
        m = (marg > 0).to(torch.float32)
        cost = torch.clamp(marg, min=0.0).sum() / (batch * NC)
        dz4 = (m - onehot * m.sum(dim=1, keepdim=True)) * (
            1.0 / (batch * NC))
        return cost, true_s.min(), dz4
    if spec.loss == "exp":
        zc4 = z4 - z4.mean(dim=1, keepdim=True)
        true_s = (zc4 * onehot).sum(dim=1, keepdim=True)
        e = torch.exp(-true_s)
        dz4 = (e * (1.0 / batch)) * (1.0 / NC - onehot)
        return e.sum() / batch, true_s.min(), dz4
    zc = z4 - z4.amax(dim=1, keepdim=True)
    logp = zc - torch.log(torch.exp(zc).sum(dim=1, keepdim=True))
    tl = (logp * onehot).sum(dim=1, keepdim=True)
    if spec.loss == "nll":
        cost = -tl.sum() / batch
        dz4 = (torch.exp(logp) - onehot) * (1.0 / batch)
    elif spec.loss == "nllsq":
        # squared log-likelihood, not negated
        cost = (tl * tl).sum() / batch
        dz4 = (2.0 * tl * (1.0 / batch)) * (onehot - torch.exp(logp))
    else:   # 'nllT': the clamp's gradient is zero where it is active
        cost = torch.clamp(spec.log_thresh - tl, min=0.0).sum() / batch
        gate = (spec.log_thresh - tl > 0).to(torch.float32)
        dz4 = (gate * (1.0 / batch)) * (torch.exp(logp) - onehot)
    return cost, tl.min(), dz4


def aux_encoder(spec, aux, db, w1, b1, w2, b2):
    """LocationInfo in the fused family (megastep_deep.py:1331-1345,
    1367-1376): the convex row mix of the (B, 4) aux rows with u from
    dropout lane 0, times ``boost``, then 2 -> nah (leaky .5) -> nao
    (leaky .01). Returns (x2, z1, h1, z2, h2)."""
    u = _u01(db[:, 0:1])
    x2 = (aux[:, 0:2] * u + aux[:, 2:4] * (1.0 - u)) * spec.boost
    z1 = x2 @ w1 + b1
    h1 = _act(z1, "leaky", 0.5)
    z2 = h1 @ w2 + b2
    return x2, z1, h1, z2, _act(z2, "leaky", 0.01)


def _softaux_head(spec, f, y, db, aux, tail):
    """The SoftAux head's forward and hand-derived backward
    (megastep_deep.py:1367-1415): (cost less weight cost, minf, its eight
    gradients, dL/df). The cross bias gets the scores bias's gradient."""
    B = spec.batch
    Wt, bt, w1a, b1a, w2a, b2a, cw, cb = tail
    x2, z1a, h1a, z2a, h2a = aux_encoder(spec, aux, db, w1a, b1a, w2a, b2a)
    z4 = f @ Wt + bt + cb + h2a @ cw
    cost, minf, dz4 = head_loss(spec, z4, y, B)
    dbt = dz4.sum(dim=0, keepdim=True)
    dz2a = (dz4 @ cw.T) * _dact(z2a, "leaky", 0.01)
    dz1a = (dz2a @ w2a.T) * _dact(z1a, "leaky", 0.5)
    grads = [f.T @ dz4, dbt, x2.T @ dz1a, dz1a.sum(dim=0, keepdim=True),
             h1a.T @ dz2a, dz2a.sum(dim=0, keepdim=True), h2a.T @ dz4, dbt]
    return cost, minf, grads, dz4 @ Wt.T


def mean_flatten(p):
    """The MeanLayer flatten of the last pooled level p (B, M, pn, pn): each
    position times 1/pn^2, summed in row-major order (the CUDA kernel's
    order). Returns (B, M)."""
    inv = 1.0 / (p.shape[2] * p.shape[3])
    rows = (p * inv).reshape(p.shape[0], p.shape[1], -1)
    f = rows[:, :, 0]
    for j in range(1, rows.shape[2]):
        f = f + rows[:, :, j]
    return f


def mean_flatten_grad(df, shape):
    """The gradient of mean_flatten at every position of ``shape``: df
    (B, M) times 1/pn^2."""
    inv = 1.0 / (shape[2] * shape[3])
    return (df * inv)[:, :, None, None].expand(shape)


def deep_step_reference(spec, x, y, ub, fb, pb, db, params, centers, gh, gw,
                        aux=None, auxw=None):
    """One step of the deep family in plain PyTorch (``_deep_fwd_bwd``,
    megastep_deep.py:1176-1524): augmentation, forward, hand-derived
    backward. ``x`` (C0*B, HW) channel-major rows, ``y`` (B,) int32, one
    step's noise words, ``aux`` the step's (B, 4) aux rows and ``auxw``
    aux_concat_weights (None without them). Returns (cost, minf, grads) in
    kernel layout."""
    B, H, C0, n = spec.batch, spec.img, spec.in_ch, spec.n_levels
    m = len(spec.pre_hidden)
    ws, bs = params[0:2 * n:2], params[1:2 * n:2]
    pre = [(params[2 * n + 2 * j], params[2 * n + 2 * j + 1])
           for j in range(m)]
    if spec.learn_centers:
        centers = params[-1]

    a = augment(spec, x, ub, fb, pb, gh, gw)
    inp = a.reshape(C0, B, H, H).transpose(0, 1)           # (B, C0, H, H)
    saved, cin, levels = [], C0, spec.levels
    for k in range(n):
        M, (_, pad, cs, c, _) = spec.maps[k], levels[k]
        z = _conv_true(inp, ws[k], spec.filts[k], cin, pad, cs, c) + bs[
            k].reshape(1, M, 1, 1)
        r, p = _pool(spec.pools[k], spec.ibs[k],
                     _act(z, spec.acts[k], spec.slopes[k]))
        saved.append((inp, z, r, p))
        inp, cin = p, M
    if spec.mean_tail:
        f = mean_flatten(inp)
    else:
        f = inp.reshape(B, -1)   # flat nets: (B, C0*HW), flatten(2) order
    conv_cost = weight_cost(list(zip(spec.regs, zip(ws, bs))))

    if spec.head == "softaux":
        tail = params[2 * n:2 * n + 8]
        cost, minf, tail_grads, df = _softaux_head(spec, f, y, db, aux, tail)
        cost = cost + conv_cost + weight_cost([(spec.reg_o, tail)])
        dpre, df_rows = [], df
    else:
        cost, minf, tail_grads, dpre, df_rows = _dense_tail(
            spec, f, y, db, params, pre, centers, aux, auxw)
        cost = cost + conv_cost
    dconv = []
    if n:
        shape = saved[-1][3].shape
        df = df_rows[:, :spec.n_flat]
        dp = (mean_flatten_grad(df, shape) if spec.mean_tail
              else df.reshape(shape))
    for k in range(n - 1, -1, -1):
        inp, z, r, p = saved[k]
        side_in, pad, cs, c, _ = levels[k]
        dz = pool_backward(r, p, dp, c) * _dact(z, spec.acts[k],
                                                spec.slopes[k])
        dconv.append((_conv_true_wgrad(inp, dz, spec.filts[k], pad, cs),
                      dz.sum(dim=(0, 2, 3)).reshape(-1, 1)))
        if k:
            dp = _conv_true_dgrad(dz, ws[k], spec.filts[k], spec.maps[k - 1],
                                  side_in, pad, cs)
    dconv.reverse()
    grads = [g for pair in dconv + dpre for g in pair]
    return cost, minf, grads + tail_grads


def _dense_tail(spec, f, y, db, params, pre, centers, aux, auxw):
    """[AuxConcat ->] the pre-hiddens, the final hidden and a softmax-kind
    or CenteredOut head, forward and backward. Returns (cost less the conv
    levels' weight cost, minf, the hidden's and head's gradients, the
    pre-hiddens' gradient pairs, dL/d flatten or None)."""
    B, n, m = spec.batch, spec.n_levels, len(spec.pre_hidden)
    wh, bh, wo, bo = params[2 * n + 2 * m:2 * n + 2 * m + 4]
    off = 0
    if spec.aux_concat:
        # the frozen encoder's output joins the flatten; its mix reads
        # dropout lane 0 and the pre-hiddens' lanes start at 1
        h2a = aux_encoder(spec, aux, db, *_unpack_aux_weights(spec, auxw))[4]
        f = torch.cat([f, h2a], dim=1)
        off = 1
    # pre-hiddens read db lanes [off, off + width), the final hidden the
    # last n_hid lanes
    pre_saved = []
    for (nh, kind, slope, pd), (w, b) in zip(spec.pre_hidden, pre):
        z = f @ w + b
        h = _act(z, kind, slope)
        mask = ((_u01(db[:, off:off + nh]) >= pd).to(torch.float32)
                if pd else None)
        pre_saved.append((f, z, mask))
        f = h * mask if pd else h
        off += nh
    z3 = f @ wh + bh
    h3 = _act(z3, spec.act_h, spec.slope_h)
    mask3 = ((_u01(db[:, db.shape[1] - spec.n_hid:]) >= spec.pdrop)
             .to(torch.float32) if spec.pdrop else None)
    h3d = h3 * mask3 if spec.pdrop else h3
    z4 = h3d @ wo + bo
    if spec.head == "softmax":
        cost, minf, dz4 = head_loss(spec, z4, y, B)
        dcenters = None
    else:
        cost, minf, dz4, dcenters = centered_nll(spec, z4, y, centers)
    head_wts = (wo, bo, centers) if spec.learn_centers else (wo, bo)
    cost = cost + weight_cost(
        list(zip(spec.regs_pre, pre)) + [(spec.reg_h, (wh, bh)),
                                         (spec.reg_o, head_wts)])

    dwo = h3d.T @ dz4
    dbo = dz4.sum(dim=0, keepdim=True)
    dh3 = dz4 @ wo.T
    if spec.pdrop:
        dh3 = dh3 * mask3
    dz3 = dh3 * _dact(z3, spec.act_h, spec.slope_h)
    dwh = f.T @ dz3
    dbh = dz3.sum(dim=0, keepdim=True)
    df = dz3 @ wh.T if (n or m) else None
    dpre = []
    for j in range(m - 1, -1, -1):
        f_in, z, mask = pre_saved[j]
        _, kind, slope, pd = spec.pre_hidden[j]
        dz = (df * mask if pd else df) * _dact(z, kind, slope)
        dpre.append((f_in.T @ dz, dz.sum(dim=0, keepdim=True)))
        df = dz @ pre[j][0].T if (j or n) else None
    dpre.reverse()
    grads = [dwh, dbh, dwo, dbo] + ([dcenters] if spec.learn_centers else [])
    return cost, minf, grads, dpre, df


def _step_aux(aux_steps, s):
    return None if aux_steps is None else aux_steps[s]


@torch.no_grad()
def deep_epoch_reference(kparams, kmoms, x_steps, y_steps, bits, lr, spec,
                         aux_steps=None):
    """The plain PyTorch twin of the CUDA deep kernel (and of the JAX
    package's ``_kernel_deep``). ``x_steps`` (nb, C0*B, HW) f32
    channel-major rows, ``y_steps`` (nb, B) int32, ``bits`` from
    epoch_noise_bits, ``aux_steps`` (nb, B, 4) f32 for a net with an aux
    layer. Returns (kparams, kmoms, cost_minf (nb, 2)) as new tensors."""
    ub, fb, pb, db = bits
    nb, dev = x_steps.shape[0], x_steps.device
    lr = torch.tensor(lr, dtype=torch.float32, device=dev)
    params = [t.clone() for t in kparams]
    moms = [t.clone() for t in kmoms]
    gh, gw, centers, auxw = deep_step_constants(spec, dev)
    kinds = deep_reg_kinds(spec)
    cm = torch.empty((nb, 2), dtype=torch.float32, device=dev)
    for s in range(nb):
        cost, minf, grads = deep_step_reference(
            spec, x_steps[s], y_steps[s], ub[s, 0], fb[s], pb[s], db[s],
            params, centers, gh, gw, _step_aux(aux_steps, s), auxw)
        cm[s, 0], cm[s, 1] = cost, minf
        apply_updates(kinds, params, moms, grads, lr)
    return params, moms, cm


# --------------------------------------------------------------- the kernel

def check_aux(name, spec, aux, lead):
    """Raise unless ``aux`` is what a step (``lead`` ()) or an epoch
    (``lead`` (nb,)) of ``spec`` reads: (*lead, B, 4) f32 when the spec
    has an aux layer, else None."""
    if not spec.has_aux:
        if aux is not None:
            raise ValueError(f"{name}: the net has no aux layer, but aux "
                             "rows were given")
        return
    if aux is None:
        raise ValueError(f"{name}: the net's aux layer needs aux rows")
    check_tensors(name, [(aux, (*lead, spec.batch, 4), torch.float32)])


def launch_deep(name, kparams, kmoms, x_steps, y_steps, bits, lr, spec,
                aux_steps=None):
    """Check the inputs and run one epoch of csrc/megastep_deep.cu on the
    current stream; returns (kparams, kmoms, cost_minf) as new tensors."""
    from . import _build

    check_epoch_inputs(name, kparams, kmoms, x_steps, y_steps, bits, spec,
                       deep_kernel_shapes(spec))
    check_aux(name, spec, aux_steps, (x_steps.shape[0],))
    dev = x_steps.device
    params = [t.clone() for t in kparams]   # updated in place by the kernel
    moms = [t.clone() for t in kmoms]
    cm = torch.empty((x_steps.shape[0], 2), dtype=torch.float32, device=dev)
    _build.deep_launch(spec, x_steps, y_steps, bits,
                       deep_step_constants(spec, dev), aux_steps, params,
                       moms, cm, float(lr))
    return params, moms, cm


def deep_epoch(kparams, kmoms, x_steps, y_steps, bits, lr, spec,
               aux_steps=None):
    """Train one epoch; same contract as deep_epoch_reference.

    A CPU ``x_steps`` runs the plain twin. A CUDA ``x_steps`` launches the
    hand-written CUDA kernel (one C call per epoch) and counts the launch
    in ``deep_epoch.launches``; any other device raises."""
    if x_steps.device.type == "cpu":
        return deep_epoch_reference(kparams, kmoms, x_steps, y_steps, bits,
                                    lr, spec, aux_steps)
    if x_steps.device.type != "cuda":
        raise ValueError(f"deep_epoch: no kernel for {x_steps.device}")
    out = launch_deep("deep_epoch", kparams, kmoms, x_steps, y_steps, bits,
                      lr, spec, aux_steps)
    deep_epoch.launches += 1
    return out


deep_epoch.launches = 0


# ------------------------------------------------- the data-parallel step

def deep_step_constants(spec, device):
    """The constant tensors a deep step reads on ``device``: the warp's
    smoothing factors, the frozen CenteredOut centers and the frozen
    AuxConcat encoder (None where the net has none); made once per epoch,
    as megastep.step_constants."""
    return (*smoothing_factors(spec, device), frozen_centers(spec, device),
            aux_concat_weights(spec, device))


@torch.no_grad()
def deep_grad_step_reference(spec, consts, x, y, words, params, grads, cm,
                             aux=None):
    """The plain PyTorch version of one data-parallel step's gradient in the
    deep family (the JAX package's ``_kernel_grad`` through
    ``_deep_fwd_bwd``): deep_step_reference at ``spec`` (the per-rank
    batch) with deep_step_constants ``consts`` and the step's (B, 4)
    ``aux`` rows, writing the data gradients of every state tensor back to
    back into ``grads`` and (cost, minf) into ``cm`` (2,); as
    megastep.megastep_grad_step_reference."""
    gh, gw, centers, auxw = consts
    cost, minf, g = deep_step_reference(spec, x, y, *words, params, centers,
                                        gh, gw, aux, auxw)
    grads.copy_(torch.cat([t.reshape(-1) for t in g]))
    cm[0], cm[1] = cost, minf


def deep_grad_step(spec, consts, x, y, words, params, grads, cm, aux=None):
    """One step's gradient; same contract as deep_grad_step_reference.

    CPU tensors run the plain version. CUDA tensors launch
    ``deep_grad_step`` of csrc/megastep_deep.cu (one C call: the epoch
    kernel's stages up to the last weight gradient) and count the launch
    in ``deep_grad_step.launches``; any other device raises."""
    if x.device.type == "cpu":
        return deep_grad_step_reference(spec, consts, x, y, words, params,
                                        grads, cm, aux)
    if x.device.type != "cuda":
        raise ValueError(f"deep_grad_step: no kernel for {x.device}")
    check_step_inputs("deep_grad_step", x, y, words, params, grads, cm, spec,
                      deep_kernel_shapes(spec))
    check_aux("deep_grad_step", spec, aux, ())
    from . import _build

    _build.deep_grad_launch(spec, x, y, words, consts, aux, params, grads,
                            cm)
    deep_grad_step.launches += 1


deep_grad_step.launches = 0


@torch.no_grad()
def deep_update_reference(spec, params, moms, grads, lr):
    """The plain update after the gradient all-reduce, in place (as
    megastep.megastep_update_reference)."""
    apply_updates(deep_reg_kinds(spec), params, moms,
                  split_grads(grads, deep_kernel_shapes(spec)),
                  torch.tensor(lr, dtype=torch.float32, device=grads.device))


def deep_update(spec, params, moms, grads, lr):
    """The update after the all-reduce; same contract as
    deep_update_reference. CPU tensors run the plain version; CUDA tensors
    launch ``deep_update`` of csrc/megastep_deep.cu and count it in
    ``deep_update.launches``; any other device raises."""
    if grads.device.type == "cpu":
        return deep_update_reference(spec, params, moms, grads, lr)
    if grads.device.type != "cuda":
        raise ValueError(f"deep_update: no kernel for {grads.device}")
    check_update_inputs("deep_update", params, moms, grads,
                        deep_kernel_shapes(spec))
    from . import _build

    _build.deep_update_launch(spec, params, moms, grads, float(lr))
    deep_update.launches += 1


deep_update.launches = 0

"""Whole-epoch fused training of the flat-MLP pattern.

Port of ``theanet_tpu/ops/megastep_mlp.py``: Input/Elastic -> Hidden
(fusable activation, pdrop) -> Softmax(nll), any channel count. One call
trains a whole epoch: augmentation from injected bits, the dense forward,
the backward down to the hidden weights (nothing below is learnable), and
the update.

The JAX package's ``_kernel_mlp`` computes the same function as its deep
family at zero conv levels, one hidden and a Softmax(nll) head, and its
deep matcher defers this pattern to it. So the port runs it through the
deep family's code at that spec (``as_deep``): the twin is the deep twin,
and the CUDA wrapper launches ``csrc/megastep_deep.cu`` with a zero-level
table. The MLP family keeps its own matcher, layouts, wrapper and launch
counter (``mlp_epoch.launches``), so a run shows which family trained it.
"""

from __future__ import annotations

from typing import NamedTuple

from .megastep import LayerReg, act_of, aug_of, reg_of
from .megastep_deep import (DeepSpec, deep_epoch_reference,
                            deep_launch_reason, launch_deep)

__all__ = ["MlpSpec", "mlp_spec_from_net", "MLP_LAYER_IDX", "as_deep",
           "mlp_kernel_shapes", "kernel_layout_mlp", "framework_layout_mlp",
           "mlp_epoch_reference", "mlp_epoch"]

# layer indices of the two parameterized layers of the pattern
MLP_LAYER_IDX = (1, 2)


class MlpSpec(NamedTuple):
    """The JAX MlpSpec without its TPU field (exact_movement)."""
    batch: int
    img: int            # input H = W
    n_hid: int
    n_out: int
    slope_h: float
    pdrop: float
    translation: float
    zoom: float
    magnitude: float
    sigma: int
    pflip: float
    angle: float
    invert: bool
    nearest: bool
    reg_h: LayerReg
    reg_o: LayerReg
    in_ch: int = 1
    act_h: str = "leaky"

    @property
    def hw(self):
        return self.img * self.img

    @property
    def n_flat(self):
        return self.in_ch * self.hw


def mlp_spec_from_net(net):
    """An MlpSpec when ``net`` is Input/Elastic -> Hidden -> Softmax(nll)
    with a fusable hidden activation and no frozen layer, else None
    (megastep_mlp.py:98-154; the deep kernel's launch limits in place of
    the VMEM budget)."""
    from ..layers import ElasticLayer, HiddenLayer, InputLayer, SoftmaxLayer

    L = net.net_layers
    if net.fused_tail:
        return None
    if not (len(L) == 3 and type(L[0]) in (InputLayer, ElasticLayer)
            and type(L[1]) is HiddenLayer and type(L[2]) is SoftmaxLayer):
        return None
    hid, head = L[1], L[2]
    act_h = act_of(hid.actvn)
    if head.loss != "nll" or act_h is None:
        return None
    if any(not lyr.reg["rate"] for lyr in (hid, head)):
        return None
    spec = MlpSpec(batch=net.batch_sz, img=L[0].out_sz, n_hid=hid.n_out,
                   n_out=head.n_out, slope_h=act_h[1], act_h=act_h[0],
                   pdrop=float(hid.pdrop), **aug_of(L[0]),
                   reg_h=reg_of(hid), reg_o=reg_of(head),
                   in_ch=L[0].num_maps)
    # the deep kernel runs it: its launch limits (the deep matcher, which
    # then sees the same net, names the reason)
    return None if deep_launch_reason(as_deep(spec)) else spec


def as_deep(spec):
    """The DeepSpec of the same function: no conv level, one hidden, a
    Softmax(nll) head."""
    return DeepSpec(
        batch=spec.batch, img=spec.img, filts=(), pools=(), ibs=(), maps=(),
        slopes=(), n_hid=spec.n_hid, n_out=spec.n_out, slope_h=spec.slope_h,
        act_h=spec.act_h, pdrop=spec.pdrop, translation=spec.translation,
        zoom=spec.zoom, magnitude=spec.magnitude, sigma=spec.sigma,
        pflip=spec.pflip, angle=spec.angle, invert=spec.invert,
        nearest=spec.nearest, regs=(), reg_h=spec.reg_h, reg_o=spec.reg_o,
        in_ch=spec.in_ch, head="softmax", n_classes=spec.n_out)


def mlp_kernel_shapes(spec):
    """The 4 kernel-layout state shapes: (NF, NH), (1, NH), (NH, NC),
    (1, NC)."""
    return [(spec.n_flat, spec.n_hid), (1, spec.n_hid),
            (spec.n_hid, spec.n_out), (1, spec.n_out)]


def kernel_layout_mlp(allwts, spec):
    """[[wh, bh], [wo, bo]] -> the 4 kernel-layout tensors (biases as
    rows)."""
    (wh, bh), (wo, bo) = allwts
    return [t.contiguous() for t in (wh, bh.reshape(1, spec.n_hid), wo,
                                     bo.reshape(1, spec.n_out))]


def framework_layout_mlp(kparams, spec):
    """Inverse of kernel_layout_mlp."""
    wh, bh, wo, bo = kparams
    return [[wh, bh.reshape(spec.n_hid)], [wo, bo.reshape(spec.n_out)]]


def mlp_epoch_reference(kparams, kmoms, x_steps, y_steps, bits, lr, spec):
    """The plain PyTorch twin of the flat-MLP epoch (of the JAX package's
    ``_kernel_mlp``): the deep twin at ``as_deep(spec)``."""
    return deep_epoch_reference(kparams, kmoms, x_steps, y_steps, bits, lr,
                                as_deep(spec))


def mlp_epoch(kparams, kmoms, x_steps, y_steps, bits, lr, spec):
    """Train one epoch; same contract as mlp_epoch_reference.

    A CPU ``x_steps`` runs the plain twin. A CUDA ``x_steps`` launches the
    deep CUDA kernel at the zero-level table (one C call per epoch) and
    counts the launch in ``mlp_epoch.launches``; any other device raises."""
    if x_steps.device.type == "cpu":
        return mlp_epoch_reference(kparams, kmoms, x_steps, y_steps, bits,
                                   lr, spec)
    if x_steps.device.type != "cuda":
        raise ValueError(f"mlp_epoch: no kernel for {x_steps.device}")
    out = launch_deep("mlp_epoch", kparams, kmoms, x_steps, y_steps, bits,
                      lr, as_deep(spec))
    mlp_epoch.launches += 1
    return out


mlp_epoch.launches = 0

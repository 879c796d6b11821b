"""Input-stage layers: InputLayer, ElasticLayer and ColorLayer (port of
``theanet_tpu/layers/input.py``; reference theanet/layer/inlayers.py and
color.py).

In train mode an active layer draws its randomness from the step's
``torch.Generator`` (the fused epochs draw theirs as injected words
instead): the ElasticLayer its warp and flip words (``ops.elastic``), the
ColorLayer three (B, maps) uniforms (``draw_color``), each split from the
arithmetic that uses it so a test can feed the JAX package's draws."""

from __future__ import annotations

import math

import torch

from ..inits import consume_stream_seed
from ..ops.elastic import ElasticConfig, elastic_augment
from .base import Layer

__all__ = ["InputLayer", "ElasticLayer", "ColorLayer", "draw_color",
           "color_jitter"]


class InputLayer(Layer):
    """Identity pass-through (reference inlayers.py:12-26)."""

    def __init__(self, img_sz, num_maps=1, rand_gen=None):
        super().__init__()
        self.out_sz = img_sz
        self.num_maps = num_maps
        self.n_out = num_maps * img_sz**2
        self.representation = (
            "Input Maps:{} Sizes Input:{:2d} Output:{:2d}".format(
                num_maps, img_sz, img_sz
            )
        )

    def apply(self, wts, x, *, train, generator=None):
        return x


class ElasticLayer(Layer):
    """Augmentation layer (reference inlayers.py:29-163). One warp per
    batch. Eval mode keeps only invert (TestVersion, inlayers.py:157-163)."""

    def __init__(
        self,
        img_sz,
        num_maps=1,
        translation=0,
        zoom=1,
        magnitude=0,
        sigma=1,
        pflip=0,
        angle=0,
        rand_gen=None,
        invert_image=False,
        nearest=False,
        method="auto",
    ):
        super().__init__()
        assert zoom > 0
        self.cfg = ElasticConfig(
            img_sz=img_sz, translation=translation, zoom=zoom,
            magnitude=magnitude, sigma=sigma, pflip=pflip, angle=angle,
            invert_image=invert_image, nearest=nearest,
        )
        self.method = method
        self.out_sz = img_sz
        self.num_maps = num_maps
        self.n_out = num_maps * img_sz**2
        # the RandomStreams seed draw in reference order (inlayers.py:72-73),
        # only when augmentation is active — init parity depends on it
        self.stream_seed = (
            0 if self.cfg.is_identity else consume_stream_seed(rand_gen)
        )
        self.representation = (
            "Elastic Maps:{:d} Size:{:2d} Translation:{} Zoom:{} Mag:{:d} "
            "Sig:{:d} Noise:{} Angle:{} Invert:{} Interpolation:{}".format(
                num_maps, img_sz, translation, zoom, magnitude, sigma,
                pflip, angle, invert_image,
                "Nearest" if nearest else "Linear",
            )
        )

    def apply(self, wts, x, *, train, generator=None):
        out = elastic_augment(x, self.cfg, train=train, method=self.method,
                              generator=generator)
        return out.to(x.dtype)


def draw_color(generator, batch, maps, device):
    """The ColorLayer's draws: (3, batch, maps) uniforms in [-1, 1), for
    the white balance, the gamma and the inverse gamma, in that order."""
    return 2.0 * torch.rand((3, batch, maps), generator=generator,
                            device=device) - 1.0


def color_jitter(x, u, balance, gamma, maxval):
    """The ColorLayer's train transform (input.py:145-163) from its draws
    ``u`` (3, B, maps): each factor is exp(ln a * u) per sample and
    channel."""
    def pos_rand(k, a):
        return torch.exp(math.log(a) * u[k])[:, :, None, None].to(x.dtype)

    out = x / maxval
    out = torch.clamp(out * pos_rand(0, balance), 0.0, 1.0)
    out = out ** pos_rand(1, gamma)
    out = 1.0 - (1.0 - out) ** pos_rand(2, gamma)
    return out * maxval


class ColorLayer(Layer):
    """Per-sample, per-channel photometric jitter (reference color.py:9-52):
    x/maxval, white balance exp(ln b * U(-1,1)), clip to [0,1], gamma
    x**g1, inverse gamma 1-(1-x)**g2, times maxval. Eval mode, and a layer
    with balance == gamma == 1, is the identity."""

    def __init__(self, img_sz, num_maps=3, rand_gen=None, balance=1, gamma=1,
                 maxval=1):
        super().__init__()
        self.out_sz = img_sz
        self.num_maps = num_maps
        self.n_out = num_maps * img_sz**2
        self.balance = balance
        self.gamma = gamma
        self.maxval = maxval
        self.identity = gamma == 1 and balance == 1
        if not self.identity:
            assert gamma > 0 and balance > 0
        # the RandomStreams seed draw (color.py), only when the jitter is
        # active: every later init draw shifts with it
        self.stream_seed = (0 if self.identity
                            else consume_stream_seed(rand_gen))
        self.representation = (
            "Color Maps:{} Size:{:2d} Balance:{:.2f} Gamma:{:.2f} "
            "Maxval:{}".format(num_maps, img_sz, balance, gamma, maxval))

    def apply(self, wts, x, *, train, generator=None):
        if self.identity or not train:
            return x
        u = draw_color(generator, x.shape[0], self.num_maps, x.device)
        return color_jitter(x, u, self.balance, self.gamma, self.maxval)

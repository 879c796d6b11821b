"""Input-stage layers: InputLayer, ElasticLayer and ColorLayer (port of
``theanet_tpu/layers/input.py``; reference theanet/layer/inlayers.py and
color.py).

Active train-mode augmentation (an elastic warp, a color jitter) runs only
inside the fused epoch kernels (ops/megastep.py, ops/megastep_deep.py). A
per-layer training call with an active config raises instead of silently
skipping it; the per-layer port is queued in ROADMAP.md."""

from __future__ import annotations

from ..inits import consume_stream_seed
from ..ops.elastic import ElasticConfig
from .base import Layer

__all__ = ["InputLayer", "ElasticLayer", "ColorLayer"]


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
        if train and not self.cfg.is_identity:
            raise NotImplementedError(
                "per-layer train-mode elastic augmentation is not ported "
                "yet (ROADMAP.md queue 1, 'per-layer augmentation': "
                "ops/elastic.py sample_warp/resample/pixel_flip); nets with "
                "an active ElasticLayer train through the fused epoch "
                "(MEGAFUSED)")
        return 1.0 - x if self.cfg.invert_image else x


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
        if train and not self.identity:
            raise NotImplementedError(
                "per-layer train-mode color jitter is not ported yet "
                "(ROADMAP.md queue 1, 'per-layer augmentation'); nets with "
                "an active ColorLayer train through the fused epoch "
                "(MEGAFUSED)")
        return x

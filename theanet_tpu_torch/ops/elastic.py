"""Elastic augmentation: config, warp, resample and pixel flip.

Port of ``theanet_tpu/ops/elastic.py`` (reference theanet/layer/
inlayers.py:29-163). One warp target (2, h, w) is sampled per batch and
applied to every image and channel; only the pixel flip is per element.
Pipeline order: translate -> smoothed Box-Muller field -> zoom and rotate
about a random origin -> clip to [0, size-1-.001] -> nearest or bilinear
resample -> pflip.

Each draw is split from its arithmetic, so a test can feed the JAX
package's own draws: ``draw_warp`` takes the 7 affine uniforms and the
(2, h, w) normal field from a ``torch.Generator``, ``warp_from_draws``
computes the target from them, and ``pixel_flip`` reads injected 32-bit
words (a pixel flips where the low 24 bits, as a uniform, are below
pflip). ``elastic_augment`` is the per-layer train path; with
``method='pallas'`` it runs the resample, invert and flip as one call of
``ops/elastic_resample.py`` (its CUDA kernel on a card). The fused epochs
(``ops/megastep.py``) run the same warp from their own words.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["ElasticConfig", "gaussian_band_matrices", "draw_warp",
           "warp_from_draws", "sample_warp", "clip_warp", "resample",
           "draw_flip_words", "pixel_flip", "elastic_augment"]


class ElasticConfig(NamedTuple):
    img_sz: int
    translation: float = 0
    zoom: float = 1
    magnitude: float = 0
    sigma: int = 1
    pflip: float = 0
    angle: float = 0
    invert_image: bool = False
    nearest: bool = False

    @property
    def is_identity(self) -> bool:
        # reference short-circuit (inlayers.py:67-70): invert still applies
        return (
            not (self.magnitude or self.translation or self.pflip or self.angle)
            and self.zoom == 1
        )


@functools.lru_cache(maxsize=32)
def gaussian_band_matrices(h: int, w: int, sigma: int):
    """Banded smoothing matrices (G_h, G_w): G_h @ field @ G_w^T equals the
    reference's 2-D Gaussian 'full'-conv-then-crop (inlayers.py:87-96),
    because filt[i, j] = k1[i] * k1[j] with
    k1[i] = exp(-i^2/(2 s^2)) / sqrt(2 pi s^2). Cached: treat as read-only."""
    var = float(sigma) ** 2
    taps = np.arange(-sigma, sigma + 1, dtype=np.float64)
    k1 = np.exp(-0.5 * taps * taps / var) / math.sqrt(2 * math.pi * var)

    def band(n):
        g = np.zeros((n, n), dtype=np.float32)
        for d, v in zip(range(-sigma, sigma + 1), k1):
            idx = np.arange(max(0, -d), min(n, n - d))
            g[idx, idx + d] = v
        return g

    return band(h), band(w)


@functools.lru_cache(maxsize=32)
def _warp_constants(h: int, w: int, sigma: int, device: str):
    """The identity grid (2, h, w) and the smoothing factors on ``device``,
    made once: a copy from the host each step would wait for the device."""
    gh, gw = gaussian_band_matrices(h, w, sigma)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (np.indices((h, w)), gh, gw))


def draw_warp(generator, cfg: ElasticConfig, h: int, w: int, device):
    """The warp's draws, in this order: 7 uniforms in [-1, 1) (translation
    y/x, origin y/x, zoom y/x, angle; elastic.py:101-108), then, when the
    config has an elastic field, its (2, h, w) standard normals (else
    None)."""
    u = 2.0 * torch.rand(7, generator=generator, device=device) - 1.0
    normals = (torch.randn((2, h, w), generator=generator, device=device)
               if cfg.magnitude else None)
    return u, normals


def warp_from_draws(u, normals, cfg: ElasticConfig, h: int, w: int):
    """The unclipped warp target (2, h, w) f32 from the draws of
    ``draw_warp`` (elastic.py:94-155). The field's Gaussian smoothing sums
    in the fused kernels' one order (``megastep._smooth``)."""
    from .megastep import _smooth

    target, gh, gw = _warp_constants(h, w, int(cfg.sigma), str(u.device))
    if cfg.translation:
        target = target + cfg.translation * u[0:2].reshape(2, 1, 1)
    if cfg.magnitude:
        target = target + _smooth(gh, cfg.magnitude * normals, gw)
    if cfg.zoom != 1 or cfg.angle:
        origin = torch.stack([(0.5 + 0.25 * u[2]) * h,
                              (0.5 + 0.25 * u[3]) * w]).reshape(2, 1, 1)
        target = target - origin
        if cfg.zoom != 1:
            target = target * torch.exp(math.log(cfg.zoom)
                                         * u[4:6].reshape(2, 1, 1))
        if cfg.angle:
            theta = cfg.angle * math.pi / 180.0 * u[6]
            c, s = torch.cos(theta), torch.sin(theta)
            # the reference's tensordot(rotate, target, axes=((0, 0)))
            # with rotate [[c, -s], [s, c]] (inlayers.py:115)
            target = torch.stack([c * target[0] + s * target[1],
                                  -s * target[0] + c * target[1]])
        target = target + origin
    return target


def sample_warp(generator, cfg: ElasticConfig, h: int, w: int, device):
    """One batch's warp target (2, h, w), drawn from ``generator``."""
    u, normals = draw_warp(generator, cfg, h, w, device)
    return warp_from_draws(u, normals, cfg, h, w)


def clip_warp(target, h, w):
    """(ty, tx), each clipped to [0, size-1-.001]: the margin keeps the
    bilinear +1 taps in range (inlayers.py:121-137)."""
    return (torch.clamp(target[0], 0.0, h - 1 - 0.001),
            torch.clamp(target[1], 0.0, w - 1 - 0.001))


def _resample_gather(x, ty, tx, nearest: bool):
    """Advanced-index gather; x is (B, C, H, W), ty/tx (h, w)."""
    if nearest:
        # iround, half away from zero; coordinates are non-negative so
        # floor(v + .5) is the same (inlayers.py:124-127)
        vert = torch.floor(ty + 0.5).long()
        horz = torch.floor(tx + 0.5).long()
        return x[:, :, vert, horz]
    topp, left = ty.long(), tx.long()   # trunc == floor here
    fy = ty - topp
    fx = tx - left
    return (x[:, :, topp, left] * (1 - fy) * (1 - fx)
            + x[:, :, topp, left + 1] * (1 - fy) * fx
            + x[:, :, topp + 1, left] * fy * (1 - fx)
            + x[:, :, topp + 1, left + 1] * fy * fx)


def _resample_matrix(ty, tx, h, w, nearest: bool):
    """Dense (hw, hw) sampling matrix S, S[p, q] the tap weight of source
    pixel q for output pixel p; out = x_flat @ S^T (elastic.py:185-212)."""
    hw = h * w
    cols = torch.arange(hw, device=ty.device).reshape(1, hw)
    if nearest:
        q = (torch.floor(ty + 0.5).long() * w
             + torch.floor(tx + 0.5).long()).reshape(hw, 1)
        return (cols == q).to(torch.float32)
    topp, left = ty.long(), tx.long()
    fy = (ty - topp).reshape(hw, 1)
    fx = (tx - left).reshape(hw, 1)
    e = (cols == (topp * w + left).reshape(hw, 1)).to(torch.float32)
    # the other taps are column shifts of the base one-hot; the clip keeps
    # q00 + w + 1 <= hw - 1, so no shift wraps
    return (e * ((1 - fy) * (1 - fx))
            + torch.roll(e, 1, dims=1) * ((1 - fy) * fx)
            + torch.roll(e, w, dims=1) * (fy * (1 - fx))
            + torch.roll(e, w + 1, dims=1) * (fy * fx))


def resample(x, target, *, nearest: bool = False, method: str = "auto"):
    """Resample x (B, C, H, W) at the warp ``target`` (2, h, w).

    method: 'gather', 'matmul', 'pallas' (the elastic_resample kernel on
    a card, its plain version on the CPU, at any image size) or 'auto'
    (matmul for hw <= 1600, gather above)."""
    b, c, h, w = x.shape
    x = x.to(torch.float32)
    ty, tx = clip_warp(target, h, w)
    if method == "auto":
        method = "matmul" if h * w <= 1600 else "gather"
    if method == "gather":
        return _resample_gather(x, ty, tx, nearest)
    if method == "pallas":
        from .elastic_resample import elastic_resample

        return elastic_resample(x.contiguous(), ty.contiguous(),
                                tx.contiguous(), None, nearest=nearest)
    if method == "matmul":
        s = _resample_matrix(ty, tx, h, w, nearest)
        return (x.reshape(b * c, h * w) @ s.T).reshape(b, c, h, w)
    raise ValueError(f"unknown resample method: {method}")


def draw_flip_words(generator, shape, device):
    """One int32 word per element for the pixel flip."""
    return torch.randint(-2**31, 2**31, tuple(shape), dtype=torch.int32,
                         generator=generator, device=device)


def pixel_flip(x, words, pflip: float):
    """v -> 1-v where the element's word, as a uniform in [0, 1) from its
    low 24 bits, is below ``pflip`` (inlayers.py:140-142)."""
    u = (words & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
    return torch.where(u < pflip, 1.0 - x, x)


def elastic_augment(x, cfg: ElasticConfig, *, train: bool = True,
                    method: str = "auto", generator=None):
    """The ElasticLayer's function (elastic.py:262-307): invert only in
    eval mode or for an identity config; else draw the warp, then (when
    pflip) the flip words, from ``generator``, resample and flip. With
    ``method='pallas'`` invert, resample and flip are one call of
    ``elastic_resample``."""
    if not train or cfg.is_identity:
        return 1.0 - x if cfg.invert_image else x
    b, c, h, w = x.shape
    target = sample_warp(generator, cfg, h, w, x.device)
    words = (draw_flip_words(generator, x.shape, x.device) if cfg.pflip
             else None)
    if method == "pallas":
        from .elastic_resample import elastic_resample

        ty, tx = clip_warp(target, h, w)
        return elastic_resample(
            x.to(torch.float32).contiguous(), ty.contiguous(),
            tx.contiguous(), words, nearest=cfg.nearest, pflip=cfg.pflip,
            invert=cfg.invert_image)
    if cfg.invert_image:
        x = 1.0 - x
    out = resample(x, target, nearest=cfg.nearest, method=method)
    return pixel_flip(out, words, cfg.pflip) if cfg.pflip else out

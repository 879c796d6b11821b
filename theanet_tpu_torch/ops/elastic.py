"""Elastic augmentation config and the Gaussian smoothing factors.

Port of the numpy half of ``theanet_tpu/ops/elastic.py`` (reference
theanet/layer/inlayers.py:29-163). The warp itself (translate -> smoothed
Box-Muller field -> zoom and rotate about a random origin -> clip to
[0, size-1-.001] -> nearest or bilinear resample -> pflip) runs inside the
fused epoch (``ops/megastep.py`` and its CUDA kernel), from injected bits.
The per-layer train-mode augmentation (``sample_warp``, ``resample``,
``pixel_flip``) is not ported yet: ROADMAP.md queue 1 lists it.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np

__all__ = ["ElasticConfig", "gaussian_band_matrices"]


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

"""The ten 5x7 digit glyphs of the synthetic datasets, upsampled: a frozen
copy of ``theanet_tpu_torch/data/synth.py``'s ``_FONT`` and ``_glyphs``."""

from __future__ import annotations

import numpy as np

_FONT = [
    "01110 10001 10011 10101 11001 10001 01110",
    "00100 01100 00100 00100 00100 00100 01110",
    "01110 10001 00001 00010 00100 01000 11111",
    "11110 00001 00001 01110 00001 00001 11110",
    "00010 00110 01010 10010 11111 00010 00010",
    "11111 10000 11110 00001 00001 10001 01110",
    "00110 01000 10000 11110 10001 10001 01110",
    "11111 00001 00010 00100 01000 01000 01000",
    "01110 10001 10001 01110 10001 10001 01110",
    "01110 10001 10001 01111 00001 00010 01100",
]


def glyphs(upsample: int = 3) -> np.ndarray:
    """(10, 7 * upsample, 5 * upsample) float32 glyphs."""
    out = []
    for pattern in _FONT:
        rows = pattern.split()
        g = np.array([[int(ch) for ch in row] for row in rows],
                     dtype=np.float32)
        g = np.kron(g, np.ones((upsample, upsample), dtype=np.float32))
        out.append(g)
    return np.stack(out)

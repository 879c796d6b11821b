"""Deterministic synthetic 10-class digit dataset (offline MNIST stand-in).

Used when the real MNIST pickle cannot be downloaded (this build environment
has no egress). Ten 5x7 glyph prototypes are upsampled, jittered, and noised
into a (N, 1, 28, 28) float32 dataset with the same interface as the MNIST
module, so every training path stays runnable and test error is a meaningful
learnable signal.
"""

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


def _glyphs(upsample: int = 3) -> np.ndarray:
    out = []
    for pattern in _FONT:
        rows = pattern.split()
        g = np.array([[int(ch) for ch in row] for row in rows], dtype=np.float32)
        g = np.kron(g, np.ones((upsample, upsample), dtype=np.float32))
        out.append(g)
    return np.stack(out)  # (10, 21, 15)


def make_dataset(n_train=12000, n_test=2000, img_sz=28, seed=42):
    rng = np.random.RandomState(seed)
    glyphs = _glyphs()
    gh, gw = glyphs.shape[1:]

    def gen(n):
        ys = rng.randint(0, 10, size=n).astype(np.int32)
        xs = np.zeros((n, 1, img_sz, img_sz), dtype=np.float32)
        oy0 = (img_sz - gh) // 2
        ox0 = (img_sz - gw) // 2
        for i in range(n):
            dy = rng.randint(-3, 4)
            dx = rng.randint(-3, 4)
            xs[i, 0, oy0 + dy : oy0 + dy + gh, ox0 + dx : ox0 + dx + gw] = glyphs[
                ys[i]
            ] * rng.uniform(0.7, 1.0)
        xs += rng.normal(0, 0.08, size=xs.shape).astype(np.float32)
        np.clip(xs, 0.0, 1.0, out=xs)
        return xs, ys

    training_x, training_y = gen(n_train)
    testing_x, testing_y = gen(n_test)
    return training_x, training_y, testing_x, testing_y


training_x, training_y, testing_x, testing_y = make_dataset()

# Auxiliary location tensors (batch, 2, 2) for aux-head configs
# (params/synth_aux.prms): deterministic pseudo-locations derived from the
# labels with per-row jitter, matching the reference's aux-data contract
# (train.py:131-135 loads data.training_aux when the net takes aux).
_aux_rng = np.random.RandomState(31415)


def _make_aux(ys):
    base = np.stack([ys % 5, ys // 5], axis=1).astype(np.float32) / 5.0
    rows = base[:, None, :] + _aux_rng.uniform(
        -0.1, 0.1, size=(len(ys), 2, 2)
    ).astype(np.float32)
    return np.clip(rows, 0.0, 1.0)


training_aux = _make_aux(training_y)
testing_aux = _make_aux(testing_y)

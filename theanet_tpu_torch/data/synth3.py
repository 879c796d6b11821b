"""Deterministic synthetic 3-channel dataset ("galaxy-style" stand-in).

Same glyph generator as ``synth`` but rendered into 3 color channels with
per-class hue mixes and per-sample color jitter, for exercising the full
ColorLayer -> ElasticLayer -> conv -> CenteredOut pipeline offline.

A copy of ``theanet_tpu/data/synth3.py`` (the port cannot import the JAX
package); ``tests/test_torch_inits_data.py`` holds the arrays bit-equal.
"""

from __future__ import annotations

import numpy as np

from .synth import _glyphs


def make_dataset(n_train=6000, n_test=1000, img_sz=28, seed=123):
    rng = np.random.RandomState(seed)
    glyphs = _glyphs()
    gh, gw = glyphs.shape[1:]
    # fixed per-class RGB mixes, away from 0 so every channel carries signal
    hues = 0.3 + 0.7 * np.random.RandomState(7).rand(10, 3).astype(np.float32)

    def gen(n):
        ys = rng.randint(0, 10, size=n).astype(np.int32)
        xs = np.zeros((n, 3, img_sz, img_sz), dtype=np.float32)
        oy0 = (img_sz - gh) // 2
        ox0 = (img_sz - gw) // 2
        for i in range(n):
            dy = rng.randint(-3, 4)
            dx = rng.randint(-3, 4)
            brightness = rng.uniform(0.7, 1.0)
            patch = glyphs[ys[i]] * brightness
            for c in range(3):
                xs[i, c, oy0 + dy : oy0 + dy + gh, ox0 + dx : ox0 + dx + gw] = (
                    patch * hues[ys[i], c]
                )
        xs += rng.normal(0, 0.05, size=xs.shape).astype(np.float32)
        np.clip(xs, 0.0, 1.0, out=xs)
        return xs, ys

    training_x, training_y = gen(n_train)
    testing_x, testing_y = gen(n_test)
    return training_x, training_y, testing_x, testing_y


training_x, training_y, testing_x, testing_y = make_dataset()

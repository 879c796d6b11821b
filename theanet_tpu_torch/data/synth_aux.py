"""Synthetic dataset with auxiliary location input.

Exercises the aux plumbing end-to-end (the reference's optional
``training_aux``/``testing_aux`` contract, train.py:131-135): each sample
carries a (2, 2) auxiliary tensor holding two noisy readings of the glyph's
(row, col) offset — the shape LocationInfo consumes (auxiliary.py:22).

A copy of ``theanet_tpu/data/synth_aux.py`` (the port cannot import the JAX
package); ``tests/test_torch_heads.py`` holds the arrays bit-equal.
"""

from __future__ import annotations

import numpy as np

from .synth import _glyphs


def make_dataset(n_train=6000, n_test=1000, img_sz=28, seed=77):
    rng = np.random.RandomState(seed)
    glyphs = _glyphs()
    gh, gw = glyphs.shape[1:]

    def gen(n):
        ys = rng.randint(0, 10, size=n).astype(np.int32)
        xs = np.zeros((n, 1, img_sz, img_sz), dtype=np.float32)
        aux = np.zeros((n, 2, 2), dtype=np.float32)
        oy0 = (img_sz - gh) // 2
        ox0 = (img_sz - gw) // 2
        for i in range(n):
            dy = rng.randint(-3, 4)
            dx = rng.randint(-3, 4)
            xs[i, 0, oy0 + dy : oy0 + dy + gh, ox0 + dx : ox0 + dx + gw] = (
                glyphs[ys[i]] * rng.uniform(0.7, 1.0)
            )
            # two noisy observations of the normalized offset
            for r in range(2):
                aux[i, r, 0] = dy / 3.0 + rng.normal(0, 0.1)
                aux[i, r, 1] = dx / 3.0 + rng.normal(0, 0.1)
        xs += rng.normal(0, 0.08, size=xs.shape).astype(np.float32)
        np.clip(xs, 0.0, 1.0, out=xs)
        return xs, ys, aux

    tx, ty, ta = gen(n_train)
    ex, ey, ea = gen(n_test)
    return tx, ty, ta, ex, ey, ea


(training_x, training_y, training_aux,
 testing_x, testing_y, testing_aux) = make_dataset()

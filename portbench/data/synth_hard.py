"""The hard synthetic digits, MNIST's offline stand-in: a frozen copy of
``theanet_tpu_torch/data/synth_hard.py``'s ``make_dataset`` (pixel noise,
a random occlusion, a low-contrast distractor glyph, 6% training label
noise), drawn from the run's seed."""

from __future__ import annotations

import numpy as np

from .glyphs import glyphs

LABEL_NOISE = 0.06


def make(n_train, n_test, img_sz, seed):
    rng = np.random.RandomState(seed)
    gl = glyphs()
    gh, gw = gl.shape[1:]

    def gen(n, train):
        ys = rng.randint(0, 10, size=n).astype(np.int32)
        xs = np.zeros((n, 1, img_sz, img_sz), dtype=np.float32)
        oy0 = (img_sz - gh) // 2
        ox0 = (img_sz - gw) // 2
        for i in range(n):
            dy = rng.randint(-3, 4)
            dx = rng.randint(-5, 6)
            img = gl[ys[i]] * rng.uniform(0.35, 1.0)
            other = rng.randint(0, 10)
            img = np.maximum(img, gl[other] * rng.uniform(0.0, 0.5))
            bh, bw = rng.randint(5, 11), rng.randint(5, 11)
            by, bx = rng.randint(0, gh - bh + 1), rng.randint(0, gw - bw + 1)
            img = img.copy()
            img[by:by + bh, bx:bx + bw] = 0.0
            xs[i, 0, oy0 + dy:oy0 + dy + gh, ox0 + dx:ox0 + dx + gw] = img
        xs += rng.normal(0, 0.30, size=xs.shape).astype(np.float32)
        np.clip(xs, 0.0, 1.0, out=xs)
        if train and LABEL_NOISE:
            flip = rng.rand(n) < LABEL_NOISE
            ys[flip] = (ys[flip] + rng.randint(1, 10, flip.sum())) % 10
        return xs, ys

    training_x, training_y = gen(n_train, True)
    testing_x, testing_y = gen(n_test, False)
    return training_x, training_y, testing_x, testing_y

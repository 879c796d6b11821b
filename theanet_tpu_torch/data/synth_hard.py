"""Hard synthetic digit dataset: the DISCRIMINATIVE offline parity task.

The plain synthetic set (theanet_tpu.data.synth) is linearly separable
enough that the reference recipe saturates at 0.00% test error, which
makes fused-vs-scanned epoch tables nearly evidence-free (VERDICT r4,
weak item 1): two paths can agree trivially when both sit at zero.
This variant is constructed so params/mnist_cnn.prms lands MID-RANGE
(2-10% test error), where a semantic difference between execution paths
would visibly bend the error curve:

  * heavier pixel noise and a wider amplitude range than synth;
  * random occlusion: a block of the glyph is blanked per sample;
  * distractor strokes: a second glyph bleeds in at low contrast;
  * 6% TRAINING label noise (test labels stay clean), deterministic
    per index — an error floor the optimizer must fight all run.

Same interface as the other data modules (training_x/_y, testing_x/_y),
so `python train.py synth_hard params/mnist_cnn.prms` runs the exact
reference protocol on it. Fully deterministic (seeded), no downloads.
"""

from __future__ import annotations

import numpy as np

from .synth import _glyphs

LABEL_NOISE = 0.06


def make_dataset(n_train=12000, n_test=2000, img_sz=28, seed=1234):
    rng = np.random.RandomState(seed)
    glyphs = _glyphs()
    gh, gw = glyphs.shape[1:]

    def gen(n, train):
        ys = rng.randint(0, 10, size=n).astype(np.int32)
        xs = np.zeros((n, 1, img_sz, img_sz), dtype=np.float32)
        oy0 = (img_sz - gh) // 2
        ox0 = (img_sz - gw) // 2
        for i in range(n):
            dy = rng.randint(-3, 4)
            dx = rng.randint(-5, 6)
            img = glyphs[ys[i]] * rng.uniform(0.35, 1.0)
            # distractor: a different class bleeds in at low contrast
            other = rng.randint(0, 10)
            img = np.maximum(img, glyphs[other] * rng.uniform(0.0, 0.5))
            # occlusion: blank a block of the glyph
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


training_x, training_y, testing_x, testing_y = make_dataset()

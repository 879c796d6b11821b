"""Synthetic traffic signs, GTSRB's offline stand-in: a frozen copy of
``theanet_tpu_torch/data/signs48.py``'s ``make_dataset`` (43 classes in
four colour and outline groups, a pictogram of one or two digit glyphs
within each group; per-sample position, size, background, brightness and
pixel noise), drawn from the run's seed as (n, 3, img_sz, img_sz) float32
images in [0, 1] and int32 labels."""

from __future__ import annotations

import numpy as np

from .glyphs import glyphs

N_CLASSES = 43
# (name, classes) of the colour and outline groups, in label order
GROUPS = (("red ring", 12), ("blue disc", 8), ("red triangle", 15),
          ("yellow diamond", 8))
CHUNK = 1024            # samples rendered (and noise bytes drawn) at a time
NOISE_STEP = 0.04 * np.sqrt(3.0) / 127.5    # uniform noise of sd 0.04
TEMPLATE, EXTENT = 96, 1.1  # the signs' drawings: pixels a side, radii

_RED = (0.80, 0.08, 0.10)
_WHITE = (0.95, 0.95, 0.95)
_BLUE = (0.08, 0.28, 0.75)
_BLACK = (0.05, 0.05, 0.05)
_YELLOW = (0.95, 0.78, 0.10)
# per group: the outline's colour, the inside's, the pictogram's; the
# pictogram's height (one glyph; two take 2/3 of it) and centre row, in
# units of the sign's radius
_STYLE = ((_RED, _WHITE, _BLACK, 0.9, 0.0),
          (_BLUE, _BLUE, _WHITE, 0.9, 0.0),
          (_RED, _WHITE, _BLACK, 0.55, 0.25),
          (_BLACK, _YELLOW, _BLACK, 0.6, 0.0))


def group_of(labels):
    """The colour group (index into GROUPS) of each label."""
    ends = np.cumsum([n for _, n in GROUPS])
    return np.searchsorted(ends, np.asarray(labels), side="right")


def _pictograms():
    """(43, 7, 11) bitmaps and (43,) heights: each class's one or two
    glyphs, a one-glyph bitmap centred in the 11 columns; within a group
    no two classes share a pictogram."""
    gl = glyphs(upsample=1)                               # (10, 7, 5)
    codes = [(d,) for d in range(10)] + [(a, b) for a in range(1, 10)
                                         for b in range(10)]
    pick = np.random.RandomState(7)
    bitmaps, heights = [], []
    for g, (_, n) in enumerate(GROUPS):
        for i in pick.choice(len(codes), n, replace=False):
            code, bm = codes[i], np.zeros((7, 11), np.float32)
            if len(code) == 1:
                bm[:, 3:8] = gl[code[0]]
            else:
                bm[:, 0:5], bm[:, 6:11] = gl[code[0]], gl[code[1]]
            bitmaps.append(bm)
            heights.append(_STYLE[g][3] * (1.0 if len(code) == 1 else 2 / 3))
    return np.stack(bitmaps), np.asarray(heights, np.float32)


def _templates():
    """(43, 4, T, T) float32: each class's sign drawn over [-EXTENT,
    EXTENT]^2 in units of its radius, the colours in channels 0-2 and the
    sign's mask in channel 3."""
    bitmaps, heights = _pictograms()
    ys = np.arange(N_CLASSES)
    g = group_of(ys)[:, None, None]
    px = (np.arange(TEMPLATE, dtype=np.float32) + 0.5) * (
        2 * EXTENT / TEMPLATE) - EXTENT
    v, u = np.broadcast_arrays(px[None, :, None], px[None, None, :])
    r = np.sqrt(u * u + v * v)
    tri = np.abs(u) * (1.8 / 1.04) - 1.0          # the triangle's sides
    outer = np.where(g == 2, (v <= 0.8) & (v >= tri),
                     np.where(g == 3, np.abs(u) + np.abs(v) <= 1.0, r <= 1.0))
    inner = outer & np.where(
        g == 0, r <= 0.72, np.where(
            g == 1, r <= 1.0, np.where(
                g == 2, (v <= 0.62) & (v >= tri + 0.45),
                np.abs(u) + np.abs(v) <= 0.8)))
    cell = (heights / 7.0)[:, None, None]
    vc = np.asarray([s[4] for s in _STYLE], np.float32)[g]
    row = np.floor((v - vc) / cell + 3.5).astype(np.int64)
    col = np.floor(u / cell + 5.5).astype(np.int64)
    ok = (row >= 0) & (row < 7) & (col >= 0) & (col < 11)
    pic = inner & ok & (bitmaps[ys[:, None, None], np.clip(row, 0, 6),
                                np.clip(col, 0, 10)] > 0)
    out = np.empty((N_CLASSES, 4, TEMPLATE, TEMPLATE), np.float32)
    for c in range(3):
        pick = [np.asarray([s[k][c] for s in _STYLE], np.float32)[g]
                for k in range(3)]
        out[:, c] = np.where(pic, pick[2], np.where(inner, pick[1], pick[0]))
    out[:, 3] = outer
    return out


def _render(ys, scale, dy, dx, bright, bg, grad, img_sz, templates):
    """The signs of one chunk as (n, 3, img_sz, img_sz) float32, before
    noise: each pixel takes its nearest template pixel."""
    half = img_sz / 2.0
    px = np.arange(img_sz, dtype=np.float32) - (half - 0.5)
    k = TEMPLATE / (2 * EXTENT * scale * half)
    iy = np.floor((px[None, :] - dy[:, None]) * k[:, None]
                  + TEMPLATE / 2).astype(np.int32)
    ix = np.floor((px[None, :] - dx[:, None]) * k[:, None]
                  + TEMPLATE / 2).astype(np.int32)
    np.clip(iy, 0, TEMPLATE - 1, out=iy)
    np.clip(ix, 0, TEMPLATE - 1, out=ix)
    plane = TEMPLATE * TEMPLATE
    idx = (ys.astype(np.int32)[:, None, None] * (4 * plane)
           + iy[:, :, None] * TEMPLATE + ix[:, None, :])
    flat = templates.reshape(-1)
    alpha = np.take(flat, idx + 3 * plane)
    ramp = (px / img_sz)[None, :, None]
    out = np.empty((ys.shape[0], 3, img_sz, img_sz), np.float32)
    for c in range(3):
        back = bg[:, c, None, None] + grad[:, c, None, None] * ramp
        sign = np.take(flat, idx + c * plane)
        out[:, c] = (back + alpha * (sign - back)) * bright[:, None, None]
    return out


def make(n_train, n_test, img_sz, seed):
    """(training_x, training_y, testing_x, testing_y): (n, 3, img_sz,
    img_sz) float32 images in [0, 1] and (n,) int32 labels in [0, 43),
    drawn from numpy's RandomState(seed), the training set first."""
    rng = np.random.RandomState(seed)
    templates = _templates()

    def gen(n):
        ys = rng.randint(0, N_CLASSES, size=n).astype(np.int32)
        scale = rng.uniform(0.62, 0.88, size=n).astype(np.float32)
        dy = rng.uniform(-3.0, 3.0, size=n).astype(np.float32)
        dx = rng.uniform(-3.0, 3.0, size=n).astype(np.float32)
        bright = rng.uniform(0.35, 1.0, size=n).astype(np.float32)
        bg = rng.uniform(0.1, 0.7, size=(n, 3)).astype(np.float32)
        grad = rng.uniform(-0.3, 0.3, size=(n, 3)).astype(np.float32)
        xs = np.empty((n, 3, img_sz, img_sz), np.float32)
        for a in range(0, n, CHUNK):
            b = min(n, a + CHUNK)
            x = _render(ys[a:b], scale[a:b], dy[a:b], dx[a:b], bright[a:b],
                        bg[a:b], grad[a:b], img_sz, templates)
            # uniform pixel noise (sd 0.04) from random bytes
            u8 = np.frombuffer(rng.bytes(x.size), np.uint8).reshape(x.shape)
            x += (u8.astype(np.float32) - 127.5) * NOISE_STEP
            np.clip(x, 0.0, 1.0, out=xs[a:b])
        return xs, ys

    training_x, training_y = gen(n_train)
    testing_x, testing_y = gen(n_test)
    return training_x, training_y, testing_x, testing_y

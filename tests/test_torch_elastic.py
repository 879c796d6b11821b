"""The port's per-layer augmentation against the JAX package's, on the CPU.

The JAX package draws from jax.random keys and the port from a
torch.Generator, so each test hands the port the JAX package's own draws:
the 7 affine uniforms and the normal field of ``sample_warp``, the pixel
flip mask (as words: 0 flips, 0xFFFFFF keeps) and the ColorLayer's
uniforms. ``elastic_pallas`` runs in interpret mode, as the JAX package's
own tests run it here.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanet_tpu.data.synth import _glyphs
from theanet_tpu.layers.input import ColorLayer as JaxColor
from theanet_tpu.ops import elastic as jel
from theanet_tpu.ops.elastic_pallas import elastic_resample_pallas

from theanet_tpu_torch.layers.input import ColorLayer, ElasticLayer, color_jitter
from theanet_tpu_torch.ops import elastic as tel
from theanet_tpu_torch.ops.elastic_resample import (elastic_resample,
                                                    elastic_resample_reference)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
FULL = dict(translation=2, zoom=1.1, magnitude=8, sigma=3, angle=5)
WARPS = {
    "full": FULL,
    "mnist_cnn": dict(translation=2, zoom=1.1, magnitude=60, sigma=15,
                      angle=5),
    "translation": dict(translation=3),
    "zoom-angle": dict(zoom=1.3, angle=20),
    "field-only": dict(magnitude=20, sigma=2),
}


def jax_draws(key, h, w):
    """The draws of theanet_tpu.ops.elastic.sample_warp (elastic.py:
    101-119) as numpy."""
    k_sc, k_el = jax.random.split(key)
    u = jax.random.uniform(k_sc, (7,), minval=-1.0, maxval=1.0)
    normals = jax.random.normal(k_el, (2, h, w))
    return np.asarray(u), np.asarray(normals)


def flip_words(mask):
    """A JAX flip (or keep) mask as the port's words: 0 where the mask is
    1 (the low-24-bit uniform 0 is below any pflip), else 0xFFFFFF."""
    return torch.tensor(np.where(np.asarray(mask) > 0, 0, 0xFFFFFF)
                        .astype(np.int32))


@pytest.mark.parametrize("name", sorted(WARPS))
@pytest.mark.parametrize("hw", [(16, 16), (28, 28), (12, 20)])
def test_warp_from_jax_draws_matches_sample_warp(name, hw):
    h, w = hw
    cfg = jel.ElasticConfig(img_sz=h, **WARPS[name])
    key = jax.random.PRNGKey(3)
    want, _ = jel.sample_warp(key, cfg, h, w)
    u, normals = jax_draws(key, h, w)
    got = tel.warp_from_draws(torch.tensor(u), torch.tensor(normals),
                              tel.ElasticConfig(img_sz=h, **WARPS[name]),
                              h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _warped(seed, shape, cfg_kw):
    """(x, target, ty, tx) as numpy: a random batch and a JAX warp."""
    b, c, h, w = shape
    rng = np.random.RandomState(seed)
    x = rng.rand(b, c, h, w).astype(np.float32)
    cfg = jel.ElasticConfig(img_sz=h, **cfg_kw)
    target, _ = jel.sample_warp(jax.random.PRNGKey(seed), cfg, h, w)
    ty, tx = jel._clip_warp(target, h, w)
    return x, np.asarray(target), np.asarray(ty), np.asarray(tx)


@pytest.mark.parametrize("nearest", [True, False])
@pytest.mark.parametrize("shape", [(4, 1, 28, 28), (3, 3, 16, 16),
                                   (2, 2, 44, 44)])
def test_resample_methods_match_jax(nearest, shape):
    """Gather, matmul and the kernel's plain version against the JAX
    gather, matmul and the Pallas kernel (interpret mode): exact for
    nearest, 1e-5 for bilinear. 44 x 44 is past the JAX hw > 1600 rule,
    where its 'pallas' falls back to the gather."""
    x, target, ty, tx = _warped(5, shape, FULL)
    tol = dict(atol=0, rtol=0) if nearest else dict(atol=1e-5, rtol=0)
    ref = np.asarray(jel.resample(jnp.asarray(x), jnp.asarray(target),
                                  nearest=nearest, method="gather"))
    outs = {m: tel.resample(torch.tensor(x), torch.tensor(target),
                            nearest=nearest, method=m).numpy()
            for m in ("gather", "matmul", "pallas", "auto")}
    outs["reference"] = elastic_resample_reference(
        torch.tensor(x), torch.tensor(ty), torch.tensor(tx), None,
        nearest=nearest).numpy()
    for name, got in outs.items():
        np.testing.assert_allclose(got, ref, err_msg=name, **tol)
    if shape[2] * shape[3] <= 1600:
        jm = np.asarray(jel.resample(jnp.asarray(x), jnp.asarray(target),
                                     nearest=nearest, method="matmul"))
        np.testing.assert_allclose(outs["matmul"], jm, **tol)
        jp = np.asarray(elastic_resample_pallas(
            jnp.asarray(x), jnp.asarray(ty), jnp.asarray(tx),
            nearest=nearest, invert=True))
        got = elastic_resample_reference(
            torch.tensor(x), torch.tensor(ty), torch.tensor(tx), None,
            nearest=nearest, invert=True).numpy()
        np.testing.assert_allclose(got, jp, **tol)


@pytest.mark.parametrize("nearest", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_pixel_flip_matches_jax_interpret_mask(nearest, seed):
    """The Pallas kernel in interpret mode flips after the kernel with
    bernoulli(fold_in(PRNGKey(0), seed), pflip); the port reads that mask
    as words (elastic_pallas.py:134-137)."""
    shape, pflip = (4, 2, 12, 12), 0.3
    x, _, ty, tx = _warped(seed + 1, shape, FULL)
    want = np.asarray(elastic_resample_pallas(
        jnp.asarray(x), jnp.asarray(ty), jnp.asarray(tx), nearest=nearest,
        pflip=pflip, invert=True, seed=seed))
    key = jax.random.fold_in(jax.random.PRNGKey(0), jnp.int32(seed))
    mask = jax.random.bernoulli(key, pflip, shape)
    assert 0 < float(np.mean(mask)) < 1
    got = elastic_resample_reference(
        torch.tensor(x), torch.tensor(ty), torch.tensor(tx), flip_words(mask),
        nearest=nearest, pflip=pflip, invert=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # pixel_flip alone against the JAX package's
    key2 = jax.random.PRNGKey(seed)
    want2 = np.asarray(jel.pixel_flip(key2, jnp.asarray(x), pflip))
    mask2 = jax.random.bernoulli(key2, pflip, shape)
    got2 = tel.pixel_flip(torch.tensor(x), flip_words(mask2), pflip)
    np.testing.assert_allclose(got2.numpy(), want2, atol=1e-6, rtol=0)


def _golden_input():
    x = np.zeros((4, 1, 28, 28), np.float32)
    x[:, 0, 3:24, 6:21] = _glyphs()[:4]
    return x


@pytest.mark.parametrize("fname,cfg_kw,seed", [
    ("elastic_nearest_k42.npy",
     dict(translation=2, zoom=1.1, magnitude=60, sigma=15, pflip=0.03,
          angle=5, nearest=True, invert_image=True), 42),
    ("elastic_bilinear_k7.npy",
     dict(translation=2, zoom=1.1, magnitude=60, sigma=15, angle=5), 7),
])
@pytest.mark.parametrize("method", ["gather", "pallas"])
def test_port_matches_golden_images(fname, cfg_kw, seed, method):
    """The golden images of tests/test_golden_elastic.py (elastic_augment
    with method='gather'), from the same keys' draws: k_warp, k_flip =
    split(key) (elastic.py:262-307)."""
    x = _golden_input()
    cfg = tel.ElasticConfig(img_sz=28, **cfg_kw)
    k_warp, k_flip = jax.random.split(jax.random.PRNGKey(seed))
    u, normals = jax_draws(k_warp, 28, 28)
    target = tel.warp_from_draws(torch.tensor(u), torch.tensor(normals), cfg,
                                 28, 28)
    words = flip_words(jax.random.bernoulli(k_flip, cfg.pflip or 0.5,
                                            x.shape))
    xt = torch.tensor(x)
    if method == "pallas":
        ty, tx = tel.clip_warp(target, 28, 28)
        got = elastic_resample(xt, ty, tx, words, nearest=cfg.nearest,
                               pflip=cfg.pflip, invert=cfg.invert_image)
    else:
        src = 1.0 - xt if cfg.invert_image else xt
        got = tel.resample(src, target, nearest=cfg.nearest, method=method)
        if cfg.pflip:
            got = tel.pixel_flip(got, words, cfg.pflip)
    golden = np.load(os.path.join(GOLDEN, fname))
    np.testing.assert_allclose(got.numpy(), golden, atol=1e-5, rtol=0)


@pytest.mark.parametrize("nearest", [True, False])
def test_elastic_layer_methods_share_the_draws(nearest):
    """An active ElasticLayer in train mode: one generator seed gives the
    same draws to every method, so 'pallas' (the kernel's plain version on
    the CPU) and 'gather' give the same batch; eval mode only inverts; no
    kernel launch is counted on the CPU."""
    kw = dict(translation=2, zoom=1.1, magnitude=8, sigma=3, pflip=0.1,
              angle=5, invert_image=True, nearest=nearest)
    x = torch.tensor(np.random.RandomState(2).rand(5, 2, 14, 14)
                     .astype(np.float32))
    launches = elastic_resample.launches
    outs = []
    for method in ("pallas", "gather", "matmul"):
        layer = ElasticLayer(14, num_maps=2, method=method,
                             rand_gen=np.random.RandomState(0), **kw)
        gen = torch.Generator().manual_seed(11)
        outs.append(layer.apply([], x, train=True, generator=gen))
        assert torch.equal(layer.apply([], x, train=False), 1.0 - x)
    for got in outs[1:]:
        np.testing.assert_allclose(got.numpy(), outs[0].numpy(), atol=1e-6,
                                   rtol=0)
    assert not torch.equal(outs[0], 1.0 - x)   # the warp moved pixels
    assert elastic_resample.launches == launches


def test_kernel_wrappers_refuse_other_devices():
    x = torch.empty((2, 1, 4, 4), device="meta")
    t = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        elastic_resample(x, t, t, None, nearest=True)


@pytest.mark.parametrize("balance,gamma,maxval", [(1.3, 1.4, 1.0),
                                                  (1.0, 2.0, 255.0),
                                                  (2.5, 1.0, 1.0)])
def test_color_jitter_matches_jax_uniforms(balance, gamma, maxval):
    """ColorLayer train mode: the JAX layer's three (B, maps) uniforms
    (split(fold_in(key, stream_seed), 3), input.py:145-163) fed to the
    port's color_jitter."""
    b, maps, img = 6, 3, 8
    x = (np.random.RandomState(4).rand(b, maps, img, img) * maxval
         ).astype(np.float32)
    jl = JaxColor(img, maps, np.random.RandomState(1), balance=balance,
                  gamma=gamma, maxval=maxval)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jl.apply([], jnp.asarray(x), key=key, train=True))
    keys = jax.random.split(jax.random.fold_in(key, jl.stream_seed), 3)
    u = np.stack([np.asarray(jax.random.uniform(k, (b, maps), minval=-1.0,
                                                maxval=1.0)) for k in keys])
    got = color_jitter(torch.tensor(x), torch.tensor(u), balance, gamma,
                       maxval)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * maxval, rtol=0)
    tl = ColorLayer(img, maps, np.random.RandomState(1), balance=balance,
                    gamma=gamma, maxval=maxval)
    assert tl.stream_seed == jl.stream_seed
    gen = torch.Generator().manual_seed(3)
    out = tl.apply([], torch.tensor(x), train=True, generator=gen)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert torch.equal(tl.apply([], torch.tensor(x), train=False),
                       torch.tensor(x))

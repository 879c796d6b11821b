"""The GTSRB column of Ciresan et al.'s multi-column DNN
(``params/gtsrb_mcdnn.prms``: 3x48x48-100C7-MP2-150C4-MP2-250C4-MP2-300N-43N)
on the CPU.

  * its route at the published widths: the deep family, no decline, no
    stage limit, at BATCH_SZ 20 and at the batches past the head threshold
    the route rule's JAX clause takes;
  * the port's fused epoch (on the CPU its plain twin,
    ``deep_epoch_reference``) and its per-layer step (``NeuralNet.
    train_step``, autograd through the framework layers) against the
    benchmark's plain reference (``portbench/reference.py``, which imports
    nothing of the port), from the reference's own initial weights and
    noise words of one seed: at the column's topology with maps 4/6/8 and
    hidden 16 (B 4, 3 steps) and one step at the published widths (B 4);
  * the fused twin and the per-layer step against the JAX package at the
    same narrow topology: its deep epoch in interpret mode in
    ``tests/test_torch_megastep_deep.py`` (case ``gtsrb-column``), its
    per-layer ``train_step`` here;
  * the data generator ``data/signs48.py``.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import compare, noise, reference
from portbench.netdesc import net_from_layers
from theanet_tpu_torch.data import signs48
from theanet_tpu_torch.model import NeuralNet
from theanet_tpu_torch.ops import megastep
from theanet_tpu_torch.ops import megastep_deep as deep
from theanet_tpu_torch.ops import stage_plan
from theanet_tpu_torch.prms import load_params
from theanet_tpu_torch.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
PRMS = ROOT / "params" / "gtsrb_mcdnn.prms"
# The per-layer step's convolutions are library convolutions (F.conv2d),
# its dense products library GEMMs, each summing in its own order; the
# reference sums each conv output tap by tap. Two sound float32 sums of
# the same terms differ by a few ulps, so the first step's cost and the
# median leaf of its momenta (5% of the gradient; the gap of a leaf is
# the norm of the difference over the reference's norm) agree within REL
# (measured at most 9e-7 over three seeds). A few of the published
# widths' 3.5 million conv outputs a step sit at a max-pool near-tie or
# within an ulp of the leaky kink, where the two orders resolve them
# differently: the conv leaves' gradients then move by up to 3.8e-3
# (measured over three seeds), so every leaf is held to FLIP_REL. TF32
# products (10 mantissa bits) move the median leaf by 3.4e-4 or more and
# the worst conv leaf by 2e-2 or more at the published widths:
# test_tf32_reference_fails_the_bounds holds that.
REL = 1e-5
FLIP_REL = 1e-2
# (maps, hidden, batch, steps) of the two topologies
CASES = {"maps-4-6-8": ((4, 6, 8), 16, 4, 3),
         "published": ((100, 150, 250), 300, 4, 1)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layers(maps=None, hidden=None):
    """params/gtsrb_mcdnn.prms's layers on 3 x 48 x 48 inputs, the conv
    maps and hidden width replaced where given; its training params."""
    layers, tr, _ = load_params(str(PRMS))
    layers = [[name, dict(args)] for name, args in layers]
    layers[0][1].update(img_sz=48, num_maps=3)
    convs = [a for name, a in layers if name == "ConvLayer"]
    for a, m in zip(convs, maps or ()):
        a["num_maps"] = m
    if hidden is not None:
        layers[-2][1]["n_out"] = hidden
    return layers, tr


def _plain(layers):
    """A layer list as the benchmark's reference reads it (no img_sz or
    num_maps: it takes them from the data)."""
    out = [[name, dict(args)] for name, args in layers]
    for k in ("img_sz", "num_maps"):
        out[0][1].pop(k, None)
    return out


@pytest.mark.parametrize("batch", [20, 128, 256])
def test_route_takes_the_published_widths(batch):
    layers, tr = _layers()
    net = NeuralNet(layers, dict(tr, BATCH_SZ=batch, SEED=5))
    plan = megastep.fused_plan(net)
    assert plan is not None and plan.epoch_fn is deep.deep_epoch
    assert megastep.fused_decline_reason(net) is None
    spec = plan.spec
    assert stage_plan.stage_limit_reason(spec) is None
    assert (spec.batch, spec.img, spec.in_ch, spec.maps, spec.filts,
            spec.pools, spec.n_flat, spec.n_hid, spec.n_out) == (
        batch, 48, 3, (100, 150, 250), (7, 4, 4), (2, 2, 2), 2250, 300, 43)
    assert (spec.translation, spec.zoom, spec.magnitude, spec.angle,
            spec.pflip, spec.invert, spec.nearest) == (
        4.8, 1.1, 0.0, 5.0, 0.0, False, True)
    shapes = deep.deep_kernel_shapes(spec)
    assert sum(r * c for r, c in shapes) == 1543443


def test_benchmark_config_is_the_prms():
    """portbench/configs/gtsrb_mcdnn.json runs params/gtsrb_mcdnn.prms's
    layers and training params (its NUM_EPOCHS and MEGAFUSED aside)."""
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "gtsrb_mcdnn.json").read_text())
    prms = ast.literal_eval(PRMS.read_text())
    assert [[n, a] for n, a in prms["layers"]] == cfg["layers"]
    tr = dict(prms["training_params"])
    assert tr.pop("MEGAFUSED") is True
    tr.pop("NUM_EPOCHS")
    assert {k: v for k, v in cfg["training_params"].items()
            if k != "NUM_EPOCHS"} == tr
    assert cfg["data"] == {"generator": "signs48", "img_sz": 48,
                           "channels": 3}


def _case(name, seed):
    """(layers, training params, data, the reference's Net) of a CASES
    entry on signs48 drawn from ``seed``."""
    maps, hidden, batch, steps = CASES[name]
    layers, tr = _layers(maps, hidden)
    tr = dict(tr, BATCH_SZ=batch, SEED=seed, MEGAFUSED=True)
    data = signs48.make_dataset(n_train=batch * steps, n_test=2 * batch,
                                seed=seed + 1)
    desc = net_from_layers(_plain(layers), batch, 48, 3)
    return layers, tr, data, desc


@pytest.mark.parametrize("name", CASES)
def test_fused_epoch_equals_the_reference(name):
    """The Trainer's fused epoch (the deep twin on the CPU) from its initial
    weights gives the reference's losses, state and momenta bit for bit:
    the reference is a frozen copy of the twin's arithmetic (the convs
    summed tap by tap in the kernels' order, every max-pool tie taking the
    gradient, the same products), its initial weights and noise words
    drawn by its own copies from the same seed."""
    layers, tr, (x, y, xt, yt), desc = _case(name, 2 ** 31 + 9)
    net = NeuralNet(layers, tr)
    trainer = Trainer(net, x, y, xt, yt, device="cpu")
    assert trainer._mega_plan.epoch_fn is deep.deep_epoch
    _, costs, _ = trainer.run_epochs(1)
    trainer.evaluate("test", [0, 1])          # syncs the frame layout
    ref = compare.first_epoch(desc, _plain(layers), tr, tr["SEED"],
                              compare.step_rows(desc, x, y, "cpu"))
    assert np.array_equal(costs[0], ref["costs"])
    for got, want in ((trainer.params, ref["state"]),
                      (trainer.moms, ref["moms"])):
        got = reference.to_leaves(got, desc, "cpu")
        assert len(got) == len(want) == len(desc.state_shapes())
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _ref_step(desc, layers, tr, x, y, P):
    """The reference's first step from its initial weights: (cost, the
    momenta after it (5% of each gradient), the step's warp target)."""
    rows = compare.step_rows(desc, x, y, "cpu")
    init = reference.to_leaves(reference.init_framework(
        _plain(layers), desc, tr["SEED"]), desc, "cpu")
    bits = noise.epoch_noise_bits(tr["SEED"], 0, desc, 1, "cpu")
    with reference.exact_f32():
        _, moms, costs, _ = reference.train_epoch(
            desc, init, [torch.zeros_like(t) for t in init], *rows, bits,
            compare.learning_rate(tr, 0), P, n_steps=1)
        gh, gw = reference.smoothing_factors(desc, "cpu")
        ty, tx = reference.warp_field(desc, bits[0][0, 0], bits[1][0], gh,
                                      gw)
    return float(costs[0]), moms, torch.stack([ty, tx]).reshape(2, 48, 48)


def _per_layer_step(layers, tr, x, y, target, monkeypatch):
    """The port's per-layer first step (autograd through the framework
    layers) on the first batch, its ElasticLayer handed ``target`` as its
    warp: (cost, the momenta after it)."""
    from theanet_tpu_torch.ops import elastic

    monkeypatch.setattr(elastic, "sample_warp",
                        lambda gen, cfg, h, w, device: target.clone())
    net = NeuralNet(layers, dict(tr, MEGAFUSED=False))
    params, moms = net.init_params("cpu")
    B = tr["BATCH_SZ"]
    xb = torch.as_tensor(x[:B])
    yb = torch.as_tensor(np.asarray(y[:B], np.int64))
    _, new_m, cost, _, _ = net.train_step(
        params, moms, xb, yb, lr=net.get_rate(),
        generator=torch.Generator().manual_seed(0))
    return float(cost), new_m


def _gaps(got, want):
    """Each leaf's ||got - want|| / ||want||."""
    return [float((a - b).norm() / b.norm()) for a, b in zip(got, want)]


@pytest.mark.parametrize("name", CASES)
def test_per_layer_step_follows_the_reference(name, monkeypatch):
    layers, tr, (x, y, _, _), desc = _case(name, 2 ** 31 + 21)
    cost, moms, target = _ref_step(desc, layers, tr, x, y, reference.F32)
    got_cost, got_moms = _per_layer_step(layers, tr, x, y, target,
                                         monkeypatch)
    assert abs(got_cost - cost) <= REL * abs(cost)
    gaps = _gaps(reference.to_leaves(got_moms, desc, "cpu"), moms)
    assert len(gaps) == len(desc.state_shapes())
    assert float(np.median(gaps)) <= REL, gaps
    assert max(gaps) <= FLIP_REL, gaps


def test_per_layer_steps_follow_jax(monkeypatch):
    """The port's per-layer steps against the JAX package's
    ``NeuralNet.train_step`` at the column's topology with maps 4/6/8 and
    hidden 16 (B 4, 3 steps), from the same SEED's initial weights, both
    ElasticLayers handed one warp target of the JAX package's own draw:
    the costs within 2e-5 and every parameter and momentum within 5e-5,
    the bounds of tests/test_torch_layers.py (two library convolutions,
    each summing in its own order)."""
    import jax
    import jax.numpy as jnp

    from theanet_tpu.model import NeuralNet as JaxNet
    from theanet_tpu.ops import elastic as jel
    from theanet_tpu_torch.ops import elastic as tel

    layers, tr, (x, y, _, _), _ = _case("maps-4-6-8", 2 ** 31 + 33)
    tr = dict(tr, MEGAFUSED=False)
    jnet = JaxNet([[n, dict(a)] for n, a in layers], dict(tr))
    tnet = NeuralNet([[n, dict(a)] for n, a in layers], dict(tr))
    target, _ = jel.sample_warp(jax.random.PRNGKey(5),
                                jnet.net_layers[0].cfg, 48, 48)
    t_target = torch.tensor(np.asarray(target))
    monkeypatch.setattr(jel, "sample_warp", lambda *a, **k: (target, {}))
    monkeypatch.setattr(tel, "sample_warp",
                        lambda gen, cfg, h, w, device: t_target.clone())
    jp, jm = jnet.init_params()
    tp, tm = tnet.init_params("cpu")
    B, lr = tr["BATCH_SZ"], tnet.get_rate()
    assert lr == jnet.get_rate()
    jc, tc = [], []
    for i in range(CASES["maps-4-6-8"][3]):
        xb, yb = x[i * B:(i + 1) * B], np.asarray(y[i * B:(i + 1) * B])
        jp, jm, cost, _, _ = jnet.train_step(
            jp, jm, jnp.asarray(xb), jnp.asarray(yb, np.int32),
            key=jnet.base_key, lr=lr)
        jc.append(float(cost))
        tp, tm, cost, _, _ = tnet.train_step(
            tp, tm, torch.tensor(xb), torch.tensor(yb.astype(np.int64)),
            lr=lr, generator=torch.Generator().manual_seed(0))
        tc.append(float(cost))
    np.testing.assert_allclose(tc, jc, rtol=0, atol=2e-5)
    for js, ts in ((jp, tp), (jm, tm)):
        assert len(js) == len(ts)
        for lj, lt in zip(js, ts):
            assert len(lj) == len(lt)
            for a, b in zip(lj, lt):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                           atol=5e-5)
    assert max(abs(c) for c in tc) > 1.0 and tc[0] != tc[-1]


@pytest.mark.parametrize("name", CASES)
def test_tf32_reference_fails_the_bounds(name):
    """The reference's first step with TF32 products (operands rounded to 10
    mantissa bits) puts its median leaf far past REL: the bounds above
    would refuse a TF32 path."""
    layers, tr, (x, y, _, _), desc = _case(name, 2 ** 31 + 21)
    _, moms, _ = _ref_step(desc, layers, tr, x, y, reference.F32)
    _, moms_tf32, _ = _ref_step(desc, layers, tr, x, y, reference.TF32)
    assert float(np.median(_gaps(moms_tf32, moms))) > 10 * REL


@pytest.mark.parametrize("seed", [4343, 2 ** 31 + 77])
def test_signs48_is_deterministic_by_seed(seed):
    a = signs48.make_dataset(n_train=60, n_test=30, seed=seed)
    b = signs48.make_dataset(n_train=60, n_test=30, seed=seed)
    c = signs48.make_dataset(n_train=60, n_test=30, seed=seed + 1)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and np.array_equal(u, v)
    assert not np.array_equal(a[0], c[0])
    tx, ty, sx, sy = a
    assert tx.shape == (60, 3, 48, 48) and sx.shape == (30, 3, 48, 48)
    assert ty.shape == (60,) and sy.shape == (30,)
    assert tx.dtype == sx.dtype == np.float32
    assert ty.dtype == sy.dtype == np.int32
    assert 0.0 <= tx.min() and tx.max() <= 1.0


def test_signs48_draws_every_class_in_its_colour_groups():
    """All 43 labels in 2000 draws; every colour group holds at least 5
    classes; within a group no two classes look alike, and the groups
    differ in colour."""
    _, y, _, _ = signs48.make_dataset(n_train=2000, n_test=1, seed=11)
    assert set(np.unique(y)) == set(range(signs48.N_CLASSES))
    groups = signs48.group_of(np.arange(signs48.N_CLASSES))
    counts = np.bincount(groups, minlength=len(signs48.GROUPS))
    assert counts.tolist() == [n for _, n in signs48.GROUPS]
    assert counts.min() >= 5 and counts.sum() == 43
    t = signs48._templates()
    for g in range(len(signs48.GROUPS)):
        members = np.nonzero(groups == g)[0]
        # the same outline: one mask a group
        for k in members:
            assert np.array_equal(t[k, 3], t[members[0], 3])
        flat = t[members, :3].reshape(len(members), -1)
        assert len({row.tobytes() for row in flat}) == len(members)
    mean_colour = [t[groups == g, :3].mean(axis=(0, 2, 3))
                   for g in range(len(signs48.GROUPS))]
    for i in range(len(mean_colour)):
        for j in range(i):
            assert np.abs(mean_colour[i] - mean_colour[j]).max() > 0.05


def test_signs48_draws_its_arrays_on_first_access():
    """Importing the module draws nothing (the whole set is 1.4 GB); an
    unknown attribute raises AttributeError, as the CLI's getattr of the
    aux arrays needs."""
    assert "training_x" not in vars(signs48)
    assert getattr(signs48, "training_aux", None) is None


def test_evaluate_full_in_windows_equals_one_window(monkeypatch):
    """The CLI's final full-set rows go through the eval forward in windows
    of the test boundary's size, TEST_SAMP_SZ // BATCH_SZ batches (the
    column's 39,209 training images in one forward need tens of GB on the
    card): the size-weighted mean of the windows' statistics is the whole
    set's (the error exactly, as a count; the mean probability to float32
    rounding)."""
    layers, tr, (x, y, xt, yt), _ = _case("maps-4-6-8", 2 ** 31 + 3)
    x, y = signs48.make_dataset(n_train=40, n_test=1, seed=8)[:2]
    t = Trainer(NeuralNet(layers, tr), x, y, xt, yt, device="cpu")
    assert tr["TEST_SAMP_SZ"] // tr["BATCH_SZ"] >= 10     # one window
    whole = t.evaluate_full("train")
    assert whole == pytest.approx(t.evaluate("train", list(range(10))),
                                  rel=1e-12)
    calls = []
    real = Trainer.evaluate

    def evaluate(self, which, ids, preds_feats=False):
        calls.append(list(ids))
        return real(self, which, ids, preds_feats)

    monkeypatch.setattr(Trainer, "evaluate", evaluate)
    t.net.tr_prms["TEST_SAMP_SZ"] = 3 * tr["BATCH_SZ"] + 1
    parts = t.evaluate_full("train")
    assert calls == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9]]
    assert round(parts[0] * 40 / 100) == round(whole[0] * 40 / 100)
    assert abs(parts[1] - whole[1]) <= 1e-5 * abs(whole[1])

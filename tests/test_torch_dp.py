"""The port's fused data-parallel path against the JAX package's.

numpy makes the data, the weights and the 32-bit noise words from a seed;
both packages get the same values. Three layers of checks:

  * the arrangement of an epoch's data and words over the ranks is the JAX
    package's ``dp_epoch_arrange`` to the bit;
  * one step's gradient on a rank's shard (the port's plain version, which
    is what CPU tensors run) matches ``make_dp_step_fn(..., interpret=True)``
    within the twin tolerance of the other fused-family tests;
  * two gloo ranks on the CPU, started by the port's launcher, follow the
    single-device Trainer's trajectory at the JAX package's gates
    (``tests/test_megastep_dp.py:80-101``) and end bit-identical.

The CUDA kernels run only on a card; ``chip_smoke.py`` phases 15-16 hold
them to these plain versions there.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from theanet_tpu.model import NeuralNet as JaxNet
from theanet_tpu.ops import megastep as jm
from theanet_tpu.ops import megastep_deep as jd
from theanet_tpu.ops import megastep_dp as jdp

from theanet_tpu_torch.model import NeuralNet as TorchNet
from theanet_tpu_torch.ops import megastep as tm
from theanet_tpu_torch.ops import megastep_deep as td
from theanet_tpu_torch.ops import megastep_dp as tdp
from theanet_tpu_torch.parallel import launch
from theanet_tpu_torch.parallel.launch import train_ranks
from theanet_tpu_torch.trainer import Trainer

R1 = {"L1": 1e-4, "L2": 1e-3, "momentum": 0.9, "rate": 1.0, "maxnorm": 0.9}
R2 = {"L1": 0.0, "L2": 1e-3, "momentum": 0.95, "rate": 0.5, "maxnorm": 0.7}
ELASTIC = {"translation": 2, "zoom": 1.1, "magnitude": 8, "sigma": 3,
           "pflip": 0.03, "angle": 5, "invert_image": True, "nearest": False}

# the nets of the checks: the flagship pattern, a deep net with a Color
# prefix and a learned-center RBF head, a flat net (zero conv levels), a
# SoftAux head that reads a (B, 2, 2) aux input
NETS = {
    "flagship": (1, [
        ["ElasticLayer", dict(img_sz=12, **ELASTIC)],
        ["ConvLayer", {"num_maps": 4, "filter_sz": 3, "stride": 1,
                       "actvn": "relu10", "reg": R1}],
        ["PoolLayer", {"pool_sz": 2}],
        ["ConvLayer", {"num_maps": 6, "filter_sz": 3, "stride": 1,
                       "actvn": "relu05", "reg": R2}],
        ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 32, "pdrop": 0.5, "reg": R2}],
        ["SoftmaxLayer", {"n_out": 10, "reg": R1}]]),
    "deep-color-rbf": (3, [
        ["ColorLayer", {"img_sz": 12, "num_maps": 3, "balance": 1.2,
                        "gamma": 1.2}],
        ["ElasticLayer", dict(ELASTIC, invert_image=False)],
        ["ConvLayer", {"num_maps": 4, "filter_sz": 3, "stride": 1,
                       "actvn": "relu10", "reg": R1}],
        ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 16, "pdrop": 0.5, "reg": R2}],
        ["DropOutLayer", {"pdrop": 0.25}],
        ["CenteredOutLayer", {"n_features": 8, "n_classes": 5, "kind": "RBF",
                              "learn_centers": True, "junk_dist": 50.0,
                              "reg": R1}]]),
    "flat": (1, [
        ["ElasticLayer", dict(img_sz=12, **dict(ELASTIC, nearest=True))],
        ["HiddenLayer", {"n_out": 24, "pdrop": 0.5, "reg": R1}],
        ["SoftmaxLayer", {"n_out": 10, "reg": R2}]]),
    "softaux": (1, [
        ["ElasticLayer", dict(img_sz=12, **ELASTIC)],
        ["ConvLayer", {"num_maps": 4, "filter_sz": 3, "stride": 1,
                       "actvn": "relu10", "reg": R1}],
        ["PoolLayer", {"pool_sz": 2}],
        ["SoftAuxLayer", {"n_out": 10, "n_aux": (5, 9),
                          "aux_type": "LocationInfo", "reg": R2}]]),
}


def _layers(name):
    return [[n, dict(a)] for n, a in NETS[name][1]]


def _tr(batch, seed=31):
    return {"SEED": seed, "BATCH_SZ": batch, "NUM_EPOCHS": 2,
            "EPOCHS_TO_TEST": 1, "TEST_SAMP_SZ": batch,
            "INIT_LEARNING_RATE": 0.1, "EPOCHS_TO_HALF_RATE": 1}


def _specs(name, batch):
    """(JAX spec, port spec) of a NETS entry at ``batch``, each matched as
    its package matches a net under a mesh."""
    jnet = JaxNet(_layers(name), _tr(batch))
    tnet = TorchNet(_layers(name), _tr(batch))
    jp = jm.fused_plan(jnet, for_mesh=True)
    tp = tm.fused_plan(tnet, for_mesh=True)
    return jnet, tnet, jp.spec, tp.spec, tp


def _n_classes(ts):
    return getattr(ts, "n_classes", 0) or ts.n_out


# ------------------------------------------------------------ arrangement

@pytest.mark.parametrize("n_data", [2, 4])
def test_aux_arrangement_is_jax_dp_epoch_arrange(n_data):
    """Rank d's share of a SoftAux net's aux rows (dp_shard_aux) equals
    block d of the aux rows of the JAX package's arrangement, to the bit;
    the data's shares are dp_shard_data's as for any net."""
    B, nb = 8, 3
    _, _, js, ts, _ = _specs("softaux", B)
    assert ts.has_aux and js.has_aux
    rng = np.random.RandomState(4)
    x = rng.rand(nb * B, 1, 12, 12).astype(np.float32)
    y = rng.randint(0, 10, nb * B).astype(np.int32)
    aux = rng.randn(nb * B, 2, 2).astype(np.float32)
    out = jdp.dp_epoch_arrange(js, nb, n_data, jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(aux), jax.random.PRNGKey(17), 3,
                               False)
    jx, jaux = np.asarray(out[0]), np.asarray(out[6])
    b_loc = B // n_data
    for d in range(n_data):
        xs, _ = tdp.dp_shard_data(ts, n_data, d, torch.tensor(x),
                                  torch.tensor(y))
        np.testing.assert_array_equal(xs.numpy(),
                                      jx[:, d * b_loc:(d + 1) * b_loc])
        got = tdp.dp_shard_aux(ts, n_data, d, torch.tensor(aux))
        assert tuple(got.shape) == (nb, b_loc, 4)
        np.testing.assert_array_equal(got.numpy(),
                                      jaux[:, d * b_loc:(d + 1) * b_loc])
    assert tdp.dp_shard_aux(_specs("flagship", B)[3], n_data, 0,
                            torch.tensor(aux)) is None


@pytest.mark.parametrize("n_data", [2, 4])
@pytest.mark.parametrize("name", ["flagship", "deep-color-rbf"])
def test_arrangement_is_jax_dp_epoch_arrange(name, n_data):
    """Rank d's share of the data and of the global words equals block d of
    the JAX package's arrangement, to the bit."""
    B, nb = 8, 3
    _, _, js, ts, _ = _specs(name, B)
    assert bool(getattr(ts, "color", False)) == (name == "deep-color-rbf")
    C0, HW = ts.in_ch, ts.hw
    rng = np.random.RandomState(4)
    x = rng.rand(nb * B, C0, ts.img, ts.img).astype(np.float32)
    y = rng.randint(0, _n_classes(ts), nb * B).astype(np.int32)
    key, epoch_no = jax.random.PRNGKey(17), 3
    jx, jy, jub, jfb, jpb, jdb = (np.asarray(t) for t in jdp.dp_epoch_arrange(
        js, nb, n_data, jnp.asarray(x), jnp.asarray(y), None, key, epoch_no,
        False))
    words = jm.epoch_noise_bits(
        jax.random.fold_in(key, epoch_no + (1 << 28)), js, nb)
    ub, fb, pb, db = (np.asarray(w).view(np.int32) for w in words)
    bits = (torch.tensor(ub), torch.tensor(fb),
            torch.tensor(pb).reshape(nb, C0 * B, HW), torch.tensor(db))
    b_loc, lanes = B // n_data, fb.shape[1]
    for d in range(n_data):
        xs, ys = tdp.dp_shard_data(ts, n_data, d, torch.tensor(x),
                                   torch.tensor(y))
        rows = slice(d * C0 * b_loc, (d + 1) * C0 * b_loc)
        np.testing.assert_array_equal(xs.numpy(), jx[:, rows])
        np.testing.assert_array_equal(
            ys.numpy(), jy[:, d * b_loc:(d + 1) * b_loc, 0])
        sub, sfb, spb, sdb = tdp.dp_shard_words(ts, n_data, d, bits)
        np.testing.assert_array_equal(sub.numpy(), jub.view(np.int32))
        want_fb = (jfb[:, d * lanes:(d + 1) * lanes]
                   if getattr(ts, "color", False) else jfb)
        np.testing.assert_array_equal(sfb.numpy(), want_fb.view(np.int32))
        np.testing.assert_array_equal(spb.numpy(),
                                      jpb[:, rows].view(np.int32))
        np.testing.assert_array_equal(
            sdb.numpy(), jdb[:, d * b_loc:(d + 1) * b_loc].view(np.int32))


# --------------------------------------------------- the gradient step

@pytest.mark.parametrize("name,batch,n_data", [("flagship", 16, 2),
                                               ("deep-color-rbf", 8, 2),
                                               ("flat", 8, 2),
                                               ("softaux", 8, 2)])
def test_grad_step_matches_jax_step_kernel(name, batch, n_data):
    """One step's cost, minf and every gradient on a rank's shard: the
    port's plain gradient step against the JAX package's _kernel_grad in
    interpret mode, within the twin tolerance (atol 2e-5)."""
    jnet, tnet, js, ts, plan = _specs(name, batch)
    assert isinstance(ts, tm.MegaSpec if name == "flagship" else td.DeepSpec)
    b_loc = batch // n_data
    jl, tl = jdp.local_spec(js, b_loc), tdp.local_spec(ts, b_loc)
    assert tl.batch == jl.batch == b_loc
    C0, HW = tl.in_ch, tl.hw
    rng = np.random.RandomState(6)
    x = rng.rand(C0 * b_loc, HW).astype(np.float32)
    y = rng.randint(0, _n_classes(tl), b_loc).astype(np.int32)
    shapes = [(1, 8), (tm.fb_lanes(tl), HW), (C0 * b_loc, HW),
              (b_loc, tm.db_lanes(tl))]
    words = [rng.randint(0, 2**32, s, dtype=np.uint64).astype(np.uint32)
             for s in shapes]
    aux = (rng.randn(b_loc, 4).astype(np.float32)
           if getattr(tl, "has_aux", False) else None)
    aw = [[np.asarray(w, np.float32) for w in tnet.allwts0[i]]
          for i in plan.layer_idx]
    tp = plan.kernel_layout([[torch.tensor(w) for w in lw] for lw in aw],
                            tl)
    jkl = (jm.params_to_kernel(aw, jl) if name == "flagship"
           else jd.kernel_layout_deep(aw, jl))
    step = jdp.make_dp_step_fn(jl, interpret=True)
    jg, jcost, jminf = step(jnp.asarray(x[None]),
                            jnp.asarray(y[None, :, None]),
                            *(jnp.asarray(w[None]) for w in words),
                            [jnp.asarray(t) for t in jkl],
                            aux=None if aux is None else jnp.asarray(
                                aux[None]))
    n_grads = sum(int(t.numel()) for t in tp)
    grads = torch.empty(n_grads)
    cm = torch.empty(2)
    tw = [torch.tensor(w.view(np.int32)) for w in words]
    tdp.grad_step(tl, tdp.constants(tl, "cpu"), torch.tensor(x),
                  torch.tensor(y), (tw[0][0], tw[1], tw[2], tw[3]), tp,
                  grads, cm, None if aux is None else torch.tensor(aux))
    np.testing.assert_allclose(cm.numpy(), [float(jcost), float(jminf)],
                               rtol=0, atol=2e-5)
    assert len(jg) == len(tp)
    for g, t in zip(jg, tm.split_grads(grads, [tuple(t.shape) for t in tp])):
        np.testing.assert_allclose(t.numpy(), np.asarray(g), rtol=0,
                                   atol=2e-5)
    assert float(grads.abs().max()) > 1e-3   # the gradients are not zero


# ------------------------------------------- N ranks against one device

N_STEPS, EPOCHS = 4, 2


def _data(name, batch, seed=0):
    """training_x, training_y, testing_x, testing_y, and for the SoftAux
    net its (n, 2, 2) training_aux and testing_aux."""
    C0 = NETS[name][0]
    rng = np.random.RandomState(seed)
    n_cls = 5 if name == "deep-color-rbf" else 10
    n = N_STEPS * batch
    data = (rng.rand(n, C0, 12, 12).astype(np.float32),
            rng.randint(0, n_cls, n).astype(np.int32),
            rng.rand(2 * batch, C0, 12, 12).astype(np.float32),
            rng.randint(0, n_cls, 2 * batch).astype(np.int32))
    if name == "softaux":
        data += (rng.randn(n, 2, 2).astype(np.float32),
                 rng.randn(2 * batch, 2, 2).astype(np.float32))
    return data


def _single_device(name, batch):
    tx, ty, vx, vy, *aux = _data(name, batch)
    net = TorchNet(_layers(name), _tr(batch))
    trainer = Trainer(net, tx, ty, vx, vy, device="cpu",
                      train_aux=aux[0] if aux else None,
                      test_aux=aux[1] if aux else None)
    costs, minf = [], []
    for _ in range(EPOCHS):
        _, c, m = trainer.run_epoch()
        costs.append(c)
        minf.append(m)
        net.inc_epoch_set_rate()
    trainer.sync_net()
    return (costs, minf, [[w.numpy() for w in lw] for lw in trainer.params],
            trainer.evaluate_full("test"))


@pytest.mark.timeout_s(300)
def test_two_gloo_ranks_follow_one_device(tmp_path, monkeypatch):
    """Two gloo ranks on the CPU train each net for 2 epochs of 4 steps
    through Trainer(mesh=make_mesh(2)): step costs within rtol 1e-4 / atol
    1e-5 and minf within 1e-4 of the single-device Trainer's, final weights
    within 1e-4 (the JAX package's DP gates), both ranks' weights
    bit-identical, no kernel launch counted (CPU tensors run the plain
    versions), the test evaluation the single device's, and a checkpoint
    from rank 0 only."""
    monkeypatch.setenv("THEANET_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    batch, names = 8, ("flagship", "deep-color-rbf", "flat", "softaux")
    job = [dict(name=name, layers=_layers(name), training_params=_tr(batch),
                data=_data(name, batch), epochs=EPOCHS) for name in names]
    job_file = str(tmp_path / "job.pkl")
    with open(job_file, "wb") as f:
        pickle.dump(job, f)
    launch(train_ranks, 2, "gloo", str(tmp_path / "rendezvous"), job_file,
           str(tmp_path))
    for name in names:
        ranks = []
        for r in range(2):
            with open(tmp_path / f"{name}_rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        costs, minf, params, test = _single_device(name, batch)
        for out in ranks:
            for e in range(EPOCHS):
                np.testing.assert_allclose(out["costs"][e], costs[e],
                                           rtol=1e-4, atol=1e-5)
                np.testing.assert_allclose(out["minf"][e], minf[e],
                                           atol=1e-4)
            for lw, lr in zip(out["params"], params):
                for a, b in zip(lw, lr):
                    np.testing.assert_allclose(a, b, atol=1e-4)
            np.testing.assert_allclose(out["test"], test, atol=0.2)
            assert all(v == 0 for v in out["launches"].values()), out
        for la, lb in zip(ranks[0]["params"], ranks[1]["params"]):
            for a, b in zip(la, lb):
                np.testing.assert_array_equal(a, b)
        assert [o["wrote_checkpoint"] for o in ranks] == [True, False]
        assert os.path.exists(tmp_path / f"{name}.pkl")

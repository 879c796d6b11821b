"""The port's whole-epoch ring data-parallel path against the JAX package's.

numpy makes the data, the gradients and the inputs from a seed; both
packages get the same values. The checks, on the CPU:

  * the exchange's static plan: ``owner_groups`` is the JAX package's
    ``_owner_groups`` and ``use_rs`` its ``_use_rs``;
  * ``exchange_reference`` (the plain version of csrc/ring.cuh's exchange)
    sums in the kernel's orders, bit for bit against a numpy oracle of both
    modes;
  * ``ring_epoch_reference`` (n ranks emulated with the plain versions)
    follows ``make_ring_epoch_fn`` of the JAX package (Pallas TPU interpret
    mode, on the virtual mesh of tests/conftest.py), fed the JAX package's
    own words, within its ring gate: step costs rtol 1e-4 and state atol
    1e-4 (tests/test_megastep_ring.py:67-70; the two sum each rank's
    shard in another order inside the gradient step);
  * real gloo ranks through ``parallel.launch`` under THEANET_DP_RING=1
    (the plain exchange over one ``all_gather`` a step) are bit-equal to
    each other and to the emulation;
  * the Trainer's selection by THEANET_DP_RING.

The exchange kernel and the ring epochs run only on a card;
``chip_smoke.py`` phases 17-18 hold them to these plain versions there.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from theanet_tpu.ops import megastep as jm
from theanet_tpu.ops import megastep_deep as jd
from theanet_tpu.ops import megastep_dp as jdp
from theanet_tpu.ops import megastep_ring as jring
from theanet_tpu.parallel.mesh import make_mesh as jax_make_mesh

from theanet_tpu_torch.model import NeuralNet as TorchNet
from theanet_tpu_torch.ops import megastep_dp as tdp
from theanet_tpu_torch.ops import megastep_ring as tring
from theanet_tpu_torch.parallel import Mesh, launch, make_mesh
from theanet_tpu_torch.parallel.launch import train_ranks
from theanet_tpu_torch.trainer import Trainer

from test_torch_dp import NETS, _layers, _specs, _tr


def _kshapes(name, batch, n):
    """(JAX kernel shapes, port kernel shapes) of a NETS entry's local spec
    on an n-rank mesh."""
    _, _, js, ts, _ = _specs(name, batch)
    jl, tl = jdp.local_spec(js, batch // n), tdp.local_spec(ts, batch // n)
    return ([tuple(s) for s in jdp._family(jl)[0]],
            [tuple(s) for s in tdp.family(tl).shapes(tl)])


# ------------------------------------------------------- the static plan

@pytest.mark.parametrize("n", [3, 4, 8])
@pytest.mark.parametrize("name", sorted(NETS))
def test_owner_groups_are_jax_owner_groups(name, n):
    jshapes, tshapes = _kshapes(name, 16, 1)
    assert tshapes == jshapes
    assert tring.owner_groups(tshapes, n) == jring._owner_groups(jshapes, n)
    chunks = tring.flat_chunks(tshapes, tring.owner_groups(tshapes, n))
    covered = np.zeros(sum(r * c for r, c in tshapes), np.int64)
    for start, length, owner in chunks:
        assert 0 <= owner < n
        covered[start:start + length] += 1
    assert (covered == 1).all()   # every element owned exactly once


@pytest.mark.parametrize("env", ["auto", "0", "1"])
def test_use_rs_is_jax_use_rs(env, monkeypatch):
    monkeypatch.setenv("THEANET_RING_RS", env)
    for n in range(1, 5):
        assert tring.use_rs(n) == jring._use_rs(n), (env, n)


# ------------------------------------------------------------ the exchange

def _oracle(gs, cms, rs, chunks):
    """numpy: the ring's sums in its orders, float32 throughout."""
    n = len(gs)
    inv = np.float32(1.0 / n)
    out = np.empty_like(gs[0])
    if rs:
        for start, length, c in chunks:
            sl = slice(start, start + length)
            s = gs[(c + 1) % n][sl] + gs[(c + 2) % n][sl]
            for h in range(3, n + 1):
                s = s + gs[(c + h) % n][sl]
            out[sl] = s * inv
    else:
        s = gs[0].copy()
        for g in gs[1:]:
            s = s + g
        out = s * inv
    cost = cms[0][0]
    for cm in cms[1:]:
        cost = np.float32(cost + cm[0])
    minf = np.min(np.stack([cm[1] for cm in cms]))
    return out, np.array([cost * inv, minf], np.float32)


@pytest.mark.parametrize("rs", [False, True])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_exchange_reference_is_the_oracle_bit_for_bit(n, rs):
    _, tshapes = _kshapes("flagship", 16, n)
    chunks = tring.flat_chunks(tshapes, tring.owner_groups(tshapes, n))
    ng = sum(r * c for r, c in tshapes)
    rng = np.random.RandomState(n)
    gs = [(rng.randn(ng) * 10.0 ** rng.randint(-3, 2, ng)).astype(np.float32)
          for _ in range(n)]
    cms = [rng.rand(2).astype(np.float32) * 3 for _ in range(n)]
    got, cm = tring.exchange_reference([torch.tensor(g) for g in gs],
                                       [torch.tensor(c) for c in cms], rs,
                                       chunks)
    want, wcm = _oracle(gs, cms, rs, chunks)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(cm.numpy(), wcm)
    if n == 3:   # times (float)(1/3) is not / 3: the kernel multiplies
        total = gs[0] + gs[1] + gs[2]
        assert (total * np.float32(1 / 3) != total / np.float32(3)).any()


# ------------------------------------ the emulated ranks against JAX's ring

def _jax_words(js, nb, key, epoch_no):
    """The global epoch's words as dp_epoch_arrange draws them, as the
    port's int32 tensors."""
    words = jm.epoch_noise_bits(
        jax.random.fold_in(key, epoch_no + (1 << 28)), js, nb)
    ub, fb, pb, db = (np.asarray(w).view(np.int32) for w in words)
    return (torch.tensor(ub), torch.tensor(fb),
            torch.tensor(pb).reshape(nb, js.in_ch * js.batch, js.hw),
            torch.tensor(db))


@pytest.mark.timeout_s(600)
@pytest.mark.parametrize("name,n,rs", [("flagship", 2, "auto"),
                                       ("deep-color-rbf", 2, "1"),
                                       ("flagship", 4, "auto"),
                                       ("flat", 2, "auto"),
                                       ("softaux", 2, "auto")])
def test_ring_reference_follows_jax_ring_kernel(name, n, rs, monkeypatch):
    """One epoch of 3 steps at BATCH_SZ 8: the emulated ranks against the
    JAX package's ring kernel in interpret mode, on JAX's own words (gather
    at n = 2, reduce-scatter forced at n = 2, reduce-scatter at n = 4)."""
    monkeypatch.setenv("THEANET_RING_RS", rs)
    batch, nb = 8, 3
    jnet, tnet, js, ts, plan = _specs(name, batch)
    C0 = ts.in_ch
    n_cls = getattr(ts, "n_classes", 0) or ts.n_out
    rng = np.random.RandomState(12)
    x = rng.rand(nb * batch, C0, 12, 12).astype(np.float32)
    y = rng.randint(0, n_cls, nb * batch).astype(np.int32)
    aux = (rng.randn(nb * batch, 2, 2).astype(np.float32)
           if getattr(ts, "has_aux", False) else None)
    aw = [[np.asarray(w, np.float32) for w in tnet.allwts0[i]]
          for i in plan.layer_idx]
    jkl = (jm.params_to_kernel(aw, js) if name == "flagship"
           else jd.kernel_layout_deep(aw, js))
    mesh = jax_make_mesh(n_data=n, n_model=1)
    fn = jring.make_ring_epoch_fn(js, nb, mesh,
                                  interpret=pltpu.InterpretParams(),
                                  donate=False)
    key, lr = jax.random.PRNGKey(5), 0.1
    kp = [jnp.asarray(t) for t in jkl]
    jp, jmo, jcm = fn.from_key(
        kp, [jnp.zeros_like(t) for t in kp], jnp.asarray(x), jnp.asarray(y),
        key, 0, lr, aux_steps=None if aux is None else jnp.asarray(aux))
    bits = _jax_words(js, nb, key, 0)
    tp = plan.kernel_layout([[torch.tensor(w) for w in lw] for lw in aw], ts)
    shards = [tdp.dp_shard_data(ts, n, r, torch.tensor(x), torch.tensor(y))
              for r in range(n)]
    aux_shards = None if aux is None else [
        tdp.dp_shard_aux(ts, n, r, torch.tensor(aux)) for r in range(n)]
    pp, pm, pcm = tring.ring_epoch_reference(
        ts, n, shards, tp, [torch.zeros_like(t) for t in tp], bits, lr,
        tring.use_rs(n), aux_shards=aux_shards)
    np.testing.assert_allclose(pcm[:, 0].numpy(), np.asarray(jcm)[:, 0],
                               rtol=1e-4)
    np.testing.assert_allclose(pcm[:, 1].numpy(), np.asarray(jcm)[:, 1],
                               atol=1e-4)
    for a, b in zip(list(jp) + list(jmo), pp + pm):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4)


# ---------------------------------------------- real ranks on the CPU

N_STEPS = 3


def _rank_data(name, batch):
    rng = np.random.RandomState(2)
    C0 = NETS[name][0]
    n_cls = 5 if name == "deep-color-rbf" else 10
    n = N_STEPS * batch
    return (rng.rand(n, C0, 12, 12).astype(np.float32),
            rng.randint(0, n_cls, n).astype(np.int32),
            rng.rand(batch, C0, 12, 12).astype(np.float32),
            rng.randint(0, n_cls, batch).astype(np.int32))


def _emulate(name, batch, n, rs):
    """The emulation of the job's two epochs in this process, on one thread
    as the ranks run: (step costs per epoch, final owned-layer weights,
    their layer indices). The initial state, words and rates are the mesh
    Trainer's."""
    from theanet_tpu_torch.ops import megastep

    tx, ty, _, _ = _rank_data(name, batch)
    net = TorchNet(_layers(name), _tr(batch))
    tr = Trainer(net, tx, ty, tx, ty, mesh=_fake_mesh(n))
    spec, plan = tr._mega_spec, tr._mega_plan
    kp, km = tr._to_kernel(tr.params), tr._to_kernel(tr.moms)
    shards = [tdp.dp_shard_data(spec, n, r, tr.d_train_x, tr.d_train_y)
              for r in range(n)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        costs = []
        for _ in range(2):
            bits = megastep.epoch_noise_bits(net.tr_prms["SEED"],
                                             net.get_epoch(), spec, N_STEPS,
                                             tr.device)
            kp, km, cm = tring.ring_epoch_reference(
                spec, n, shards, kp, km, bits, net.get_rate(), rs)
            costs.append(cm[:, 0].numpy())
            net.inc_epoch_set_rate()
    finally:
        torch.set_num_threads(threads)
    return costs, plan.framework_layout(kp, spec), plan.layer_idx


@pytest.mark.timeout_s(300)
@pytest.mark.parametrize("n,batch,names", [
    (2, 8, ("flagship", "deep-color-rbf", "flat")),
    (3, 12, ("flagship",))])
def test_gloo_ranks_are_the_emulation(n, batch, names, tmp_path,
                                      monkeypatch):
    """Real ranks under THEANET_DP_RING=1 (gather at n = 2; reduce-scatter,
    'auto', at n = 3), 2 epochs of 3 steps: each rank's costs and weights
    equal the other ranks' and the emulation's, bit for bit."""
    monkeypatch.setenv("THEANET_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("THEANET_RING_RS", "auto")
    job = [dict(name=name, layers=_layers(name), training_params=_tr(batch),
                data=_rank_data(name, batch), epochs=2, dp_ring="1",
                ring_rs="auto") for name in names]
    job_file = str(tmp_path / "job.pkl")
    with open(job_file, "wb") as f:
        pickle.dump(job, f)
    launch(train_ranks, n, "gloo", str(tmp_path / "rendezvous"), job_file,
           str(tmp_path))
    for name in names:
        ranks = []
        for r in range(n):
            with open(tmp_path / f"{name}_rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        costs, params, idx = _emulate(name, batch, n, tring.use_rs(n))
        for out in ranks:
            assert out["ring"]
            assert all(v == 0 for v in out["launches"].values()), out
            for c, e in zip(out["costs"], costs):
                np.testing.assert_array_equal(c, e)
            for i, lw in zip(idx, params):
                for a, b in zip(out["params"][i], lw):
                    np.testing.assert_array_equal(a, b.numpy())
        assert [o["wrote_checkpoint"] for o in ranks] == [True] + [False] * (
            n - 1)


# ------------------------------------------------------------ selection

def _fake_mesh(n):
    return Mesh({"data": n, "model": 1}, None, 0, torch.device("cpu"))


def _data(n=32, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 1, 12, 12).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("mode", ["auto", "0", "1"])
def test_trainer_selects_by_theanet_dp_ring(mode, monkeypatch, capsys):
    """'auto' on the CPU keeps the per-step path and names why on stderr;
    '1' takes the ring; '0' the per-step path, silently."""
    monkeypatch.setenv("THEANET_DP_RING", mode)
    x, y = _data()
    tr = Trainer(TorchNet(_layers("flagship"), _tr(8)), x, y, x, y,
                 mesh=_fake_mesh(2))
    err = capsys.readouterr().err
    ring = getattr(tr._mega_epoch, "ring", False)
    assert ring == (mode == "1")
    assert tr._mega_epoch.n_data == 2
    assert tr._mega_epoch.local_spec.batch == 4
    assert ("peer-mapped memory" in err) == (mode == "auto")
    if not ring:
        assert tr._mega_epoch.__module__ == tdp.__name__


def test_ring_one_raises_with_the_reason(monkeypatch):
    """THEANET_DP_RING=1 where the ring declines (more ranks than its
    table) raises with the reason; a bad value is named."""
    monkeypatch.setenv("THEANET_DP_RING", "1")
    x, y = _data(64)
    with pytest.raises(ValueError, match="at most 8"):
        Trainer(TorchNet(_layers("flagship"), _tr(16)), x, y, x, y,
                mesh=_fake_mesh(16))
    monkeypatch.setenv("THEANET_DP_RING", "yes")
    with pytest.raises(ValueError, match="THEANET_DP_RING must be"):
        Trainer(TorchNet(_layers("flagship"), _tr(8)), x, y, x, y,
                mesh=_fake_mesh(2))


def test_world_one_ring_is_the_single_device_trainer(tmp_path, monkeypatch):
    """At one rank the ring runs no exchange: two epochs equal the
    single-device Trainer's costs, state and evaluation to the bit."""
    monkeypatch.setenv("THEANET_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("THEANET_DP_RING", "1")
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        x, y = _data()
        one = Trainer(TorchNet(_layers("flagship"), _tr(8)), x, y, x, y,
                      device="cpu")
        ring = Trainer(TorchNet(_layers("flagship"), _tr(8)), x, y, x, y,
                       mesh=make_mesh())
        assert ring._mega_epoch.ring and ring._mega_epoch.n_data == 1
        costs = []
        for tr in (one, ring):
            for _ in range(2):
                costs.append(tr.run_epoch()[1:])
                tr.net.inc_epoch_set_rate()
        for (c1, m1), (c2, m2) in zip(costs[:2], costs[2:]):
            np.testing.assert_array_equal(c1, c2)
            np.testing.assert_array_equal(m1, m2)
        for a, b in zip(one._kp + one._km, ring._kp + ring._km):
            assert torch.equal(a, b)
        assert one.evaluate_full("test") == ring.evaluate_full("test")
        ring.close()
    finally:
        dist.destroy_process_group()


def test_ring_decline_reason_names_the_gate():
    """ring_decline_reason applies the per-step path's gate first."""
    _, _, _, ts, _ = _specs("flagship", 8)
    assert "does not divide" in tring.ring_decline_reason(ts, 3,
                                                          _fake_mesh(3), "1")
    assert tring.ring_decline_reason(ts, 2, _fake_mesh(2), "1") is None
    assert "peer-mapped" in tring.ring_decline_reason(ts, 2, _fake_mesh(2),
                                                      "auto")


def test_ring_table_is_what_the_kernel_parses():
    """The ring table's layout (csrc/ring.cuh ring_parse: 7 fixed fields,
    8 buffer pointers, 4 x 8 event pointers, then the chunks); at one rank
    it carries no pointers."""
    t = list(tring.ring_table(2, 1, True, 600, [11, 22], [(0, 5, 1),
                                                          (5, 3, 0)],
                              wait_s=2.0, events=[[1, 2, 3, 4],
                                                  [5, 6, 7, 8]], host=99))
    assert t[:7] == [2, 1, 1, 600, 2_000_000_000, 2, 99]
    assert t[7:15] == [11, 22] + [0] * 6
    assert t[15:47] == list(range(1, 9)) + [0] * 24
    assert t[47:] == [0, 5, 1, 5, 3, 0]
    one = list(tring.ring_table(1, 0, False, 0, [], None))
    assert len(one) == 47 and one[5:] == [0] * 42


@pytest.mark.parametrize("hosts, declines", [
    (("node-a", "node-b"), True), (("node-a", "node-a"), False)])
def test_ring_declines_a_mesh_across_hosts(hosts, declines, monkeypatch):
    """A card mesh whose ranks span hosts keeps the per-step path under
    'auto' (CUDA IPC does not cross hosts), decided before any CUDA call;
    on one host the decline goes on to the cards' peer access."""
    _, _, _, ts, _ = _specs("flagship", 8)
    mesh = Mesh({"data": 2, "model": 1}, None, 0, torch.device("cuda", 0),
                hosts)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    why = tring.ring_decline_reason(ts, 2, mesh, "auto")
    if declines:
        assert "2 hosts (node-a, node-b)" in why and "CUDA IPC" in why
    else:
        assert why is None   # one card: no peer access to ask for


def test_make_mesh_gathers_the_hosts(tmp_path, monkeypatch):
    """make_mesh records every rank's host name, in rank order."""
    import socket

    import torch.distributed as dist

    monkeypatch.setenv("THEANET_TORCH_DEVICE", "cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        assert make_mesh().hosts == (socket.gethostname(),)
    finally:
        dist.destroy_process_group()

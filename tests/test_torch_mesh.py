"""The port's data-parallel mesh and the Trainer's mesh path, on the CPU.

``parallel.make_mesh`` against its JAX counterpart's contract (named
errors where the process group cannot fill the mesh; tensor parallelism is
not ported and says so), and ``Trainer(..., mesh=...)``: the fused
data-parallel path is selected, the JAX package's mesh checks and messages
hold, and at one rank the path is the single-device epoch to the bit.
Multi-rank runs are in ``tests/test_torch_dp.py``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from theanet_tpu.model import NeuralNet as JaxNet
from theanet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from theanet_tpu.trainer import Trainer as JaxTrainer

from theanet_tpu_torch.model import NeuralNet
from theanet_tpu_torch.ops import megastep, megastep_deep, megastep_dp
from theanet_tpu_torch.parallel import Mesh, make_mesh
from theanet_tpu_torch.trainer import Trainer


def layers(conv_mode="valid"):
    return [
        ["ElasticLayer", {"img_sz": 12, "translation": 1, "zoom": 1.05,
                          "magnitude": 5, "sigma": 3, "pflip": 0.01,
                          "angle": 2}],
        ["ConvLayer", {"num_maps": 4, "filter_sz": 3, "stride": 1,
                       "actvn": "relu10", "mode": conv_mode,
                       "reg": {"L2": 0.001}}],
        ["PoolLayer", {"pool_sz": 2}],
        ["ConvLayer", {"num_maps": 6, "filter_sz": 3, "stride": 1,
                       "actvn": "relu05"}],
        ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 32, "pdrop": 0.5, "reg": {"maxnorm": 2}}],
        ["SoftmaxLayer", {"n_out": 10}],
    ]


def prms(batch_sz=8, **kw):
    return {"SEED": 31, "BATCH_SZ": batch_sz, "NUM_EPOCHS": 1,
            "EPOCHS_TO_TEST": 1, "TEST_SAMP_SZ": batch_sz,
            "INIT_LEARNING_RATE": 0.1, "EPOCHS_TO_HALF_RATE": 1, **kw}


def data(n=32, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 1, 12, 12).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


def fake_mesh(n_data):
    """A mesh of ``n_data`` ranks seen from rank 0, for the checks that run
    before any collective."""
    return Mesh({"data": n_data, "model": 1}, None, 0, torch.device("cpu"))


@pytest.fixture
def world_of_one(tmp_path, monkeypatch):
    """A one-rank gloo process group in this process."""
    monkeypatch.setenv("THEANET_TORCH_DEVICE", "cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_make_mesh_needs_a_process_group(monkeypatch):
    monkeypatch.setenv("THEANET_TORCH_DEVICE", "cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh()


def test_make_mesh_matches_the_group(world_of_one):
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert (mesh.rank, mesh.n_data, mesh.device) == (0, 1,
                                                     torch.device("cpu"))
    with pytest.raises(ValueError, match="does not match the 1 ranks"):
        make_mesh(n_data=2)
    with pytest.raises(ValueError, match="must be positive"):
        make_mesh(n_data=0)


def test_tensor_parallel_mesh_is_not_ported():
    """JAX builds a model axis (tests/test_megastep_dp.py's TP mesh); the
    port names what it lacks."""
    assert jax_make_mesh(n_data=4, n_model=2).shape["model"] == 2
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_mesh(n_data=1, n_model=2)


def test_indivisible_batch_rejected():
    """The JAX Trainer's check and wording (trainer.py:107-112)."""
    x, y = data(60)
    with pytest.raises(ValueError, match="does not divide") as jax_err:
        JaxTrainer(JaxNet(layers(), prms(15)), x, y, x, y,
                   mesh=jax_make_mesh(n_data=4, n_model=1))
    with pytest.raises(ValueError, match="does not divide") as err:
        Trainer(NeuralNet(layers(), prms(15)), x, y, x, y,
                mesh=fake_mesh(4))
    assert str(err.value) == str(jax_err.value)


def test_net_without_fused_family_raises_with_reason():
    """The port has no per-layer data-parallel path: a mesh net that the
    fused path declines raises and names why."""
    x, y = data()
    with pytest.raises(NotImplementedError, match="mode='full'.*wash"):
        Trainer(NeuralNet(layers(conv_mode="full"), prms()), x, y, x, y,
                mesh=fake_mesh(2))
    with pytest.raises(NotImplementedError, match="MEGAFUSED=False"):
        Trainer(NeuralNet(layers(), prms(MEGAFUSED=False)), x, y, x, y,
                mesh=fake_mesh(2))


def test_dp_gate_names_its_reason():
    """dp_decline_reason (JAX's dp_supported, by name): the batch divides
    across the ranks, the family has a data-parallel kernel."""
    spec = megastep.spec_from_net(NeuralNet(layers(), prms(8)))
    assert megastep_dp.dp_decline_reason(spec, 4) is None
    assert "does not divide" in megastep_dp.dp_decline_reason(spec, 3)
    flat = [layers()[0], ["HiddenLayer", {"n_out": 16}],
            ["SoftmaxLayer", {"n_out": 10}]]
    mlp = megastep.fused_plan(NeuralNet(flat, prms())).spec
    assert "no data-parallel kernel" in megastep_dp.dp_decline_reason(mlp, 1)


def test_auto_fuses_past_32_a_rank(world_of_one):
    """MEGAFUSED='auto' fuses a per-rank shard above 32: the JAX Trainer's
    ceiling (trainer.py:328-336) picks between its fused and scanned GSPMD
    data-parallel paths, and the port has only the fused one. 64 a rank
    takes the fused data-parallel path and equals the single-device epoch
    to the bit."""
    x, y = data(128)
    one = Trainer(NeuralNet(layers(), prms(64)), x, y, x, y, device="cpu")
    dp = Trainer(NeuralNet(layers(), prms(64)), x, y, x, y,
                 mesh=make_mesh())
    assert dp._mega_epoch.local_spec.batch == 64
    c1, c2 = one.run_epoch()[1:], dp.run_epoch()[1:]
    for a, b in zip(c1, c2):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(one._kp + one._km, dp._kp + dp._km):
        assert torch.equal(a, b)


def test_fused_tail_turned_off_under_a_mesh(capsys):
    x, y = data()
    net = NeuralNet(layers(), prms(FUSED_TAIL=True))
    assert net.fused_tail and megastep.fused_plan(net) is None
    tr = Trainer(net, x, y, x, y, mesh=fake_mesh(2))
    assert not net.fused_tail
    assert "FUSED_TAIL is single-chip only; disabled under the device mesh" \
        in capsys.readouterr().err
    assert isinstance(tr._mega_spec, megastep.MegaSpec)


def test_dp_fused_path_selected(world_of_one):
    """The counterpart of tests/test_megastep_dp.py's
    test_dp_fused_path_selected: the mesh Trainer holds the data-parallel
    epoch function; a flat net takes the deep family's zero-level spec, not
    the flat-MLP family."""
    x, y = data()
    tr = Trainer(NeuralNet(layers(), prms()), x, y, x, y, mesh=make_mesh())
    assert tr._mega is not None
    assert tr._mega_epoch.__module__ == megastep_dp.__name__
    assert tr._mega_epoch.n_data == 1
    flat = [layers()[0], ["HiddenLayer", {"n_out": 16}],
            ["SoftmaxLayer", {"n_out": 10}]]
    single = Trainer(NeuralNet(flat, prms()), x, y, x, y, device="cpu")
    assert type(single._mega_spec).__name__ == "MlpSpec"
    tr = Trainer(NeuralNet(flat, prms()), x, y, x, y, mesh=make_mesh())
    assert isinstance(tr._mega_spec, megastep_deep.DeepSpec)
    assert tr._mega_spec.n_levels == 0


def test_one_rank_is_the_single_device_epoch(world_of_one):
    """At one rank the all-reduce sums one term and divides by 1, so two
    epochs through grad_step -> all_reduce -> update give the single-device
    twin's costs, state and evaluation to the bit."""
    x, y = data()
    one = Trainer(NeuralNet(layers(), prms()), x, y, x, y, device="cpu")
    dp = Trainer(NeuralNet(layers(), prms()), x, y, x, y, mesh=make_mesh())
    costs = []
    for tr in (one, dp):
        for _ in range(2):
            costs.append(tr.run_epoch()[1:])
            tr.net.inc_epoch_set_rate()
    for (c1, m1), (c2, m2) in zip(costs[:2], costs[2:]):
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(m1, m2)
    for a, b in zip(one._kp + one._km, dp._kp + dp._km):
        assert torch.equal(a, b)
    assert one.evaluate_full("test") == dp.evaluate_full("test")

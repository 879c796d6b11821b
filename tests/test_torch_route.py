"""The route rule: which fused family takes a net, in both packages.

The port's fused families take a spec when its grammar holds and either the
JAX package's byte model admits it (``theanet_tpu_torch/ops/route.py``, the
VMEM gates restated on shapes) or its head fits a block's shared memory.
Here: route.py's byte totals equal the JAX gates' own; over a sweep of
batches, heads and shapes, wherever the JAX package fuses a net the port
picks the same family; bench.py's wide model stays declined in both
packages; every net the port fused before the rule still fuses.

The JAX package's untiled candidates build constant matrices of O(B^2)
entries (its stripe masks), tens of GB at BATCH_SZ 3000. The sweep hands
its gates shape-only stand-ins of ``build_constants`` and
``build_constants_deep`` (route.py's shapes; their sizes are held to the
real builders' by ``test_route_bytes_equal_jax``), so its own tile search,
work formulas and budgets decide.
"""

import math
import types

import numpy as np
import pytest

from theanet_tpu.model import NeuralNet as JaxNet
from theanet_tpu.ops import megastep as jmega
from theanet_tpu.ops import megastep_deep as jdeep
from theanet_tpu.ops import megastep_mlp as jmlp

from theanet_tpu_torch.model import NeuralNet as TorchNet
from theanet_tpu_torch.ops import megastep
from theanet_tpu_torch.ops import megastep_deep as deep
from theanet_tpu_torch.ops import megastep_mlp as mlp
from theanet_tpu_torch.ops import route

import chip_smoke

BATCHES = (20, 32, 37, 48, 64, 128, 256, 2768, 3000)
CLASSES = (10, 457, 952, 1453)


def _tr(batch):
    return {"SEED": 3, "BATCH_SZ": batch, "NUM_EPOCHS": 1,
            "EPOCHS_TO_TEST": 1, "TEST_SAMP_SZ": batch,
            "INIT_LEARNING_RATE": 0.1, "EPOCHS_TO_HALF_RATE": 2}


def mnist_layers(n_out, img=28, maps=(4, 20)):
    return chip_smoke.wide_spec(None, img=img, maps=maps, n_hid=500,
                                n_out=n_out)[0]


def flat_layers(n_out):
    return [["InputLayer", {"img_sz": 28}],
            ["HiddenLayer", {"n_out": 1000}],
            ["SoftmaxLayer", {"n_out": n_out}]]


def three_level_layers(n_out):
    conv = lambda m, f: ["ConvLayer", {"num_maps": m, "filter_sz": f,
                                       "stride": 1, "actvn": "relu05"}]
    return [["InputLayer", {"img_sz": 28}], conv(4, 3),
            ["PoolLayer", {"pool_sz": 2}], conv(8, 3),
            ["PoolLayer", {"pool_sz": 2}], conv(8, 2),
            ["HiddenLayer", {"n_out": 200}],
            ["SoftmaxLayer", {"n_out": n_out}]]


SHAPES = {
    "mnist_cnn": mnist_layers,
    "flat": flat_layers,
    "three_level": three_level_layers,
    "img12_16_32": lambda n: mnist_layers(n, 12, (16, 32)),
    "img12_64_128": lambda n: mnist_layers(n, 12, (64, 128)),
    "img56_16_32": lambda n: mnist_layers(n, 56, (16, 32)),
    "img56_64_128": lambda n: mnist_layers(n, 56, (64, 128)),
}


def _shape_only(shapes):
    return {f"c{i}": types.SimpleNamespace(shape=s)
            for i, s in enumerate(shapes)}


@pytest.fixture
def shape_only_constants(monkeypatch):
    """Hand the JAX gates route.py's constant shapes in place of the
    constant arrays (the arrays of an untiled large batch do not fit
    memory)."""
    def flagship(spec):
        return _shape_only(route.flagship_const_shapes(spec))

    def deep_consts(spec):
        return _shape_only(route.deep_const_shapes(spec))

    monkeypatch.setattr(jmega, "build_constants", flagship)
    monkeypatch.setattr(jdeep, "build_constants_deep", deep_consts)


def jax_family(layers, tr):
    plan = jmega.fused_plan(JaxNet([[n, dict(a)] for n, a in layers],
                                   dict(tr)))
    if plan is None:
        return None
    return {"MegaSpec": "flagship", "MlpSpec": "mlp",
            "DeepSpec": "deep"}[type(plan.spec).__name__]


def port_family(layers, tr):
    plan = megastep.fused_plan(TorchNet([[n, dict(a)] for n, a in layers],
                                        dict(tr)))
    if plan is None:
        return None
    return {"megastep_epoch": "flagship", "mlp_epoch": "mlp",
            "deep_epoch": "deep"}[plan.epoch_fn.__name__]


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_port_takes_the_family_jax_takes(shape, batch,
                                         shape_only_constants):
    """Wherever the JAX package fuses a net of the sweep, the port fuses
    it with the same family (the port may fuse more: its head in shared
    memory is the rule's second clause)."""
    for n_out in CLASSES:
        layers = SHAPES[shape](n_out)
        want = jax_family(layers, _tr(batch))
        got = port_family(layers, _tr(batch))
        if want is not None:
            assert got == want, (shape, batch, n_out, got, want)


# ------------------------------------------------------------ byte totals

def _work_from_gate(gate, const_bytes, budget):
    """The gate's state + work bytes: with its constants replaced by one
    stand-in of n floats, the gate passes iff 4 n + S + W <= budget; the
    largest such n gives S + W."""
    lo, hi = -(1 << 40), 1 << 40
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if gate(mid):
            lo = mid
        else:
            hi = mid
    return budget - 4 * lo


def _check_flagship(spec_t, n_tiles, monkeypatch):
    js = jmega.MegaSpec(**spec_t._asdict(), n_tiles=n_tiles)
    real = 4 * sum(int(np.prod(c.shape))
                   for c in jmega.build_constants(js).values())
    const, state, work = route.flagship_bytes(spec_t, n_tiles)
    assert const == real
    assert state == 4 * sum(math.prod(s) for s in jmega.kernel_shapes(js)) \
        * (4 + (n_tiles > 1))

    def gate(n):
        monkeypatch.setattr(jmega, "build_constants",
                            lambda s: {"x": types.SimpleNamespace(shape=(n,))})
        return jmega.flagship_vmem_ok(js)

    assert _work_from_gate(gate, const, route.FLAGSHIP_BUDGET) == state + work
    monkeypatch.undo()
    assert (route.flagship_vmem_ok(spec_t, n_tiles)
            == jmega.flagship_vmem_ok(js))


def _check_deep(spec_t, monkeypatch):
    js = jdeep.DeepSpec(**spec_t._asdict())
    consts = jdeep.build_constants_deep(js)
    assert [tuple(c.shape) for c in consts.values()] == \
        [tuple(s) for s in route.deep_const_shapes(spec_t)]
    const, state, work = route.deep_bytes(spec_t)
    assert const == 4 * sum(int(np.prod(c.shape)) for c in consts.values())
    assert state == 4 * 3 * sum(math.prod(s)
                                for s in jdeep.deep_kernel_shapes(js))
    budget = route.FLAT_BUDGET if not spec_t.filts else route.DEEP_BUDGET

    def gate(n):
        monkeypatch.setattr(jdeep, "build_constants_deep",
                            lambda s: {"x": types.SimpleNamespace(shape=(n,))})
        return jdeep._fits_vmem(js)

    assert _work_from_gate(gate, const, budget) == state + work
    monkeypatch.undo()
    assert route.deep_fits_vmem(spec_t) == jdeep._fits_vmem(js)


def _deep_spec_of(layers, batch):
    spec, reason = deep._match(TorchNet(layers, _tr(batch)))
    assert spec is not None, reason
    return spec


FLAGSHIP_SPECS = {   # (layers, batch, n_tiles)
    "mnist-b20": (mnist_layers(10), 20, 1),
    "mnist-b32-tiled": (mnist_layers(457), 32, 4),
    "img12-wide-b4": (mnist_layers(1000, 12, (64, 128)), 4, 64),
    "elastic-3ch": ([["ElasticLayer", {"img_sz": 14, "num_maps": 3,
                                       "translation": 1, "magnitude": 5,
                                       "sigma": 3}]]
                    + mnist_layers(12, 14, (5, 7))[1:], 7, 1),
}

DEEP_SPECS = {   # (layers, batch)
    "three-level": (three_level_layers(1500), 20),
    "same-mean-rbf": ([["InputLayer", {"img_sz": 12}],
                       ["ConvLayer", {"num_maps": 3, "filter_sz": 3,
                                      "stride": 1, "mode": "same"}],
                       ["PoolLayer", {"pool_sz": 2}],
                       ["MeanLayer", {}],
                       ["HiddenLayer", {"n_out": 9}],
                       ["CenteredOutLayer", {"kind": "RBF", "n_classes": 4,
                                             "n_features": 6,
                                             "junk_dist": 2.0}]], 6),
    "full-pre-hidden": ([["ElasticLayer", {"img_sz": 11, "translation": 1}],
                         ["ConvLayer", {"num_maps": 2, "filter_sz": 3,
                                        "stride": 1, "mode": "full"}],
                         ["PoolLayer", {"pool_sz": 3}],
                         ["ConvLayer", {"num_maps": 3, "filter_sz": 2,
                                        "stride": 2}],
                         ["HiddenLayer", {"n_out": 7}],
                         ["HiddenLayer", {"n_out": 5, "pdrop": 0.5}],
                         ["SoftmaxLayer", {"n_out": 3}]], 5),
    "flat-952": (flat_layers(952), 20),
    "flat-wide": (flat_layers(457), 128),
}


@pytest.mark.parametrize("name", sorted(FLAGSHIP_SPECS))
def test_flagship_bytes_equal_jax(name, monkeypatch):
    layers, batch, n_tiles = FLAGSHIP_SPECS[name]
    spec = megastep.flagship_spec(TorchNet(layers, _tr(batch)))
    assert spec is not None
    _check_flagship(spec, n_tiles, monkeypatch)


@pytest.mark.parametrize("name", sorted(DEEP_SPECS))
def test_deep_bytes_equal_jax(name, monkeypatch):
    layers, batch = DEEP_SPECS[name]
    spec = _deep_spec_of(layers, batch)
    _check_deep(spec, monkeypatch)


@pytest.mark.parametrize("batch,n_out", [(20, 952), (128, 457),
                                         (1000, 10)])
def test_mlp_bytes_equal_jax(batch, n_out, monkeypatch):
    """The flat-MLP gate (inline in the JAX matcher): the constants of
    ``build_constants_mlp``, and its verdict at route.py's total."""
    ts = mlp.mlp_spec(TorchNet(flat_layers(n_out), _tr(batch)))
    js = jmlp.MlpSpec(**ts._asdict())
    const, state, work = route.mlp_bytes(ts)
    assert const == 4 * sum(int(np.prod(c.shape)) for c in
                            jmlp.build_constants_mlp(js).values())
    assert state == 4 * 3 * sum(
        math.prod(s) for s in mlp.mlp_kernel_shapes(ts))
    jnet = JaxNet(flat_layers(n_out), _tr(batch))

    def gate(n):
        monkeypatch.setattr(
            jmlp, "build_constants_mlp",
            lambda s: {"x": types.SimpleNamespace(shape=(n,))})
        return jmlp.mlp_spec_from_net(jnet) is not None

    assert _work_from_gate(gate, const, route.FLAT_BUDGET) == state + work
    monkeypatch.undo()
    assert (route.mlp_jax_reason(ts) is None) == (
        jmlp.mlp_spec_from_net(jnet) is not None)


# ------------------------------------------------------------- the rule

@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_wide_model_declined_by_both(dtype, shape_only_constants):
    """bench.py's wide model (56x56, conv 64 -> 128, hidden 2048, 1000
    classes, BATCH_SZ 256) fails both clauses: the JAX package declines it
    at every tile and its head does not fit shared memory."""
    layers, tr = chip_smoke.wide_spec(dtype)
    assert jmega.fused_plan(JaxNet([[n, dict(a)] for n, a in layers],
                                   dict(tr))) is None
    net = TorchNet([[n, dict(a)] for n, a in layers], dict(tr))
    assert megastep.fused_plan(net) is None
    reason = megastep.fused_decline_reason(net)
    assert "JAX package's deep VMEM model" in reason, reason
    assert "flagship VMEM model" in reason, reason
    assert "BATCH_SZ 256 x 1000" in reason, reason


PARENT_FUSED = {   # nets the port fused before the route rule
    "flat-b1000": (flat_layers(10), 1000, "mlp"),
    "three-level-b64": (three_level_layers(10), 64, "deep"),
    "three-level-b1000": (three_level_layers(10), 1000, "deep"),
    "mnist-b2767": (mnist_layers(10), 2767, "flagship"),
    "mnist-b20-1452": (mnist_layers(1452), 20, "flagship"),
}


@pytest.mark.parametrize("name", sorted(PARENT_FUSED))
def test_parent_fused_nets_still_fuse(name):
    """Nets whose head fits shared memory keep their family, whatever the
    JAX byte model says (the JAX package declines the flat net at B 1000
    and the three-level nets for VMEM)."""
    layers, batch, fam = PARENT_FUSED[name]
    assert port_family(layers, _tr(batch)) == fam


@pytest.mark.parametrize("layers,batch,fam", [
    (mnist_layers(10), 3000, "flagship"),
    (mnist_layers(457), 128, "flagship"),
    (mnist_layers(1453), 20, "flagship"),
    (flat_layers(952), 20, "mlp"),
    (three_level_layers(1500), 20, "deep"),
])
def test_heads_beyond_the_opt_in_fuse_by_the_jax_clause(layers, batch, fam):
    """Phase 23's configurations: their head exceeds the shared memory a
    block can opt in to, and the JAX clause of the rule takes them."""
    net = TorchNet([[n, dict(a)] for n, a in layers], _tr(batch))
    plan = megastep.fused_plan(net)
    assert plan is not None, megastep.fused_decline_reason(net)
    spec = plan.spec
    head = (megastep.flagship_head_smem(spec) if fam == "flagship"
            else deep.deep_head_smem(mlp.as_deep(spec) if fam == "mlp"
                                     else spec))
    assert head > megastep.SMEM_OPT_IN
    assert port_family(layers, _tr(batch)) == fam
    assert spec.batch == batch   # a tiled JAX batch runs whole

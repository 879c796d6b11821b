"""Which fused family takes a net, in the port and in the JAX package.

The port's matchers take a spec by the route rule: the JAX package's byte
model admits it, or its head fits a block's shared memory (a head beyond
the opt-in runs from the workspace). A warp field beyond a block's shared
memory is declined by name. The same rule runs on the CPU and on a card.
bench.py's wide model (batch 256, 1000 classes) fails both clauses and is
declined by both packages; every shipped .prms keeps its family; bf16 does
not stop a net from fusing.
"""

import ast
import importlib
import os

import numpy as np
import pytest

from theanet_tpu.model import NeuralNet as JaxNet
from theanet_tpu.ops import megastep as jmega

from theanet_tpu_torch.model import NeuralNet as TorchNet
from theanet_tpu_torch.ops import megastep
from theanet_tpu_torch.ops import megastep_deep as deep
from theanet_tpu_torch.ops import megastep_mlp as mlp
from theanet_tpu_torch.prms import fixdim, load_params

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_prms(batch):
    """training_params of the wide spec at ``batch``, f32."""
    return chip_smoke.wide_spec(None, batch=batch)[1]


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_port_declines_the_wide_model_by_its_head(dtype):
    """The reason names both clauses of the route rule that failed: the
    JAX package's byte models (deep and flagship) and the head's shared
    memory."""
    net = TorchNet(*chip_smoke.wide_spec(dtype, img=12))
    assert megastep.fused_plan(net) is None
    reason = megastep.fused_decline_reason(net)
    assert reason.startswith("the route rule: the JAX package's deep VMEM "
                             "model declines it"), reason
    assert "the head does not fit shared memory" in reason, reason
    assert "BATCH_SZ 256 x 1000" in reason, reason
    assert "flagship VMEM model declines BATCH_SZ 256" in reason, reason


def test_jax_declines_the_wide_model_too():
    net = JaxNet(*chip_smoke.wide_spec(None, img=12))
    assert jmega.fused_plan(net) is None


@pytest.mark.parametrize("n_out,in_smem", [(1452, True), (1453, False)])
def test_flagship_head_limit_is_the_kernels(n_out, in_smem):
    """csrc/megastep.cu keeps a head of (2 B NC + B) floats in shared memory
    up to the 227 KB a block can opt in to (at batch 20, 1452 classes and
    not 1453), and beyond it in the workspace: both fuse, as the JAX
    package fuses both (untiled at batch 20)."""
    layers, tr = chip_smoke.wide_spec(None, img=12, batch=20, maps=(2, 3),
                                      n_hid=8, n_out=n_out)
    net = TorchNet(layers, tr)
    spec = megastep.spec_from_net(net)
    assert spec is not None
    assert (megastep.flagship_head_smem(spec) <= megastep.SMEM_OPT_IN) \
        == in_smem
    assert megastep.fused_plan(net).epoch_fn is megastep.megastep_epoch
    js = jmega.spec_from_net(JaxNet(layers, tr))
    assert (js.batch, js.n_tiles) == (20, 1)


@pytest.mark.parametrize("n_out,in_smem", [(951, True), (952, False)])
def test_flat_head_limit_is_the_deep_kernels(n_out, in_smem):
    """The flat-MLP family runs the deep kernel, whose head holds (2 B NO +
    B NC + NC + 4 B) floats in shared memory up to the 227 KB a block can
    opt in to (at batch 20, 951 outputs and not 952), and beyond it in the
    workspace: both fuse in the flat-MLP family, as in the JAX package."""
    layers = [["InputLayer", {"img_sz": 6}],
              ["HiddenLayer", {"n_out": 8}],
              ["SoftmaxLayer", {"n_out": n_out}]]
    net = TorchNet(layers, small_prms(20))
    dspec = mlp.as_deep(mlp.MlpSpec(
        batch=20, img=6, n_hid=8, n_out=n_out, slope_h=0.01, pdrop=0.0,
        translation=0, zoom=1, magnitude=0, sigma=1, pflip=0.0, angle=0,
        invert=False, nearest=False, reg_h=None, reg_o=None))
    assert (deep.deep_head_smem(dspec) <= megastep.SMEM_OPT_IN) == in_smem
    assert megastep.fused_plan(net).epoch_fn is mlp.mlp_epoch
    jplan = jmega.fused_plan(JaxNet(layers, small_prms(20)))
    assert type(jplan.spec).__name__ == "MlpSpec"


@pytest.mark.parametrize("img,fuses", [(120, True), (121, False)])
def test_warp_field_limit_is_the_kernels(img, fuses):
    """k_warp keeps 4 floats a pixel in shared memory, at most 227 KB a
    block (csrc/stages.cuh warp_smem_ok): 120x120 fits, 121x121 not."""
    layers = [["ElasticLayer", {"img_sz": img, "translation": 1}],
              ["HiddenLayer", {"n_out": 4}],
              ["SoftmaxLayer", {"n_out": 3}]]
    net = TorchNet(layers, small_prms(2))
    assert megastep.warp_smem_ok(img * img) == fuses
    assert (megastep.fused_plan(net) is not None) == fuses
    if not fuses:
        assert "warp field's shared memory" in megastep.fused_decline_reason(
            net)


# each shipped .prms: its dataset and the family the port trains it with
SHIPPED = {"mnist_cnn": ("synth_hard", "megastep_epoch"),
           "galaxy_rbf": ("synth3", "deep_epoch"),
           "logit_centered": ("synth", "deep_epoch"),
           "synth_quick": ("synth", "deep_epoch"),
           "flat_mlp": ("synth_hard", "mlp_epoch"),
           "synth_aux": ("synth_aux", "deep_epoch"),
           "gtsrb_mcdnn": ("signs48", "deep_epoch")}


def shipped_layers(name):
    layers, tr, _ = load_params(os.path.join(REPO, "params", name + ".prms"))
    data = importlib.import_module("theanet_tpu_torch.data."
                                   + SHIPPED[name][0])
    # signs48 declares its shape (its arrays, 1.4 GB, are drawn on access)
    shape = ((1, data.CHANNELS, data.IMG_SZ, data.IMG_SZ)
             if hasattr(data, "IMG_SZ") else fixdim(data.training_x[:1]).shape)
    layers[0][1]["img_sz"] = shape[3]
    if "num_maps" not in layers[0][1] and shape[1] != 1:
        layers[0][1]["num_maps"] = shape[1]
    tr.setdefault("SEED", 1)
    return layers, tr


@pytest.mark.parametrize("name", sorted(SHIPPED))
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_shipped_prms_keep_their_family(name, dtype):
    layers, tr = shipped_layers(name)
    if dtype:
        tr["COMPUTE_DTYPE"] = dtype
    plan = megastep.fused_plan(TorchNet(layers, tr))
    assert plan is not None
    assert plan.epoch_fn.__name__ == SHIPPED[name][1]


def test_every_shipped_prms_is_covered():
    """Every shipped .prms has its route in SHIPPED, the one the JAX
    package takes (synth_aux's SoftAux head: the deep family)."""
    names = sorted(f[:-5] for f in os.listdir(os.path.join(REPO, "params"))
                   if f.endswith(".prms"))
    assert sorted(SHIPPED) == names
    layers, tr = shipped_layers("synth_aux")
    jnet = JaxNet([[n, dict(a)] for n, a in layers], dict(tr))
    assert type(jmega.fused_plan(jnet).spec).__name__ == "DeepSpec"
    assert megastep.fused_plan(TorchNet(layers, tr)).spec.head == "softaux"


def test_bf16_mnist_cnn_fuses_in_both_packages():
    layers, tr = shipped_layers("mnist_cnn")
    tr["COMPUTE_DTYPE"] = "bfloat16"
    tnet = TorchNet([[n, dict(a)] for n, a in layers], dict(tr))
    jnet = JaxNet([[n, dict(a)] for n, a in layers], dict(tr))
    assert megastep.fused_plan(tnet).epoch_fn is megastep.megastep_epoch
    assert jmega.fused_plan(jnet) is not None
    assert tnet.compute_dtype is not None and not tnet.fused_tail


def bench_wide_model():
    """(layers, tr_prms) as bench.py's wide_model_row writes them, read
    from its source (the function also builds and trains the net)."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "wide_model_row")
    found = {}
    for node in fn.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ("layers", "tr_prms")):
            found[node.targets[0].id] = eval(
                compile(ast.Expression(node.value), "bench.py", "eval"),
                {"B": chip_smoke.WIDE_B, "IMG": chip_smoke.WIDE_IMG})
    return found["layers"], found["tr_prms"]


def test_the_wide_slice_text_is_bench_py_s_model():
    """chip_smoke.py's phase 14 builds the wide model of bench.py, and
    its data has bench.py's shapes."""
    assert chip_smoke.wide_spec() == bench_wide_model()
    x, y = chip_smoke.wide_data(4)
    assert x.shape == (4 * 256, 1, 56, 56) and x.dtype == np.float32
    assert y.min() >= 0 and y.max() < 1000


@pytest.mark.parametrize("batch", [586, 600, 1024, 2767])
def test_mnist_cnn_fuses_past_the_old_head_limit(batch):
    """With the head kernels opting in to 227 KB of shared memory,
    mnist_cnn's head (84 B bytes at 10 classes) fuses in shared memory up
    to BATCH_SZ 2767, where it declined from 586 at 48 KB; from 2768 it
    fuses with its head in the workspace (the JAX package tiles 2768 as
    173 tiles of 16)."""
    layers, tr = shipped_layers("mnist_cnn")
    for b, in_smem in ((batch, True), (2768, False)):
        tr["BATCH_SZ"] = b
        plan = megastep.fused_plan(TorchNet([[n, dict(a)] for n, a in layers],
                                            dict(tr)))
        assert plan.epoch_fn is megastep.megastep_epoch, b
        head = megastep.flagship_head_smem(plan.spec)
        assert head > 48 * 1024
        assert (head <= megastep.SMEM_OPT_IN) == in_smem, b


def test_batch_600_fuses_and_follows_jax_tiled_kernel():
    """A flagship net at BATCH_SZ 600 with 10 classes (a 50,400-byte head,
    above the old 48 KB) fuses under MEGAFUSED=True in the port, untiled
    (its plain version on the CPU), where the JAX package tiles it (20
    tiles of 30, gradients summed over the tiles, one update a batch). Fed
    JAX's own words, the port's step costs follow JAX's tiled kernel
    (interpret mode) within rtol 1e-4 and its state within atol 1e-4: the
    two sum the batch in another order (tiles against one pass)."""
    import jax
    import jax.numpy as jnp
    import torch

    from theanet_tpu_torch.trainer import Trainer

    B, nb = 600, 3
    layers = [["ElasticLayer", {"img_sz": 12, "translation": 1, "zoom": 1.05,
                                "magnitude": 5, "sigma": 3, "pflip": 0.01,
                                "angle": 2, "nearest": True}],
              ["ConvLayer", {"num_maps": 2, "filter_sz": 3, "stride": 1,
                             "actvn": "relu05", "reg": {"L2": 1e-3}}],
              ["PoolLayer", {"pool_sz": 2}],
              ["ConvLayer", {"num_maps": 3, "filter_sz": 3, "stride": 1,
                             "actvn": "relu10"}],
              ["PoolLayer", {"pool_sz": 2}],
              ["HiddenLayer", {"n_out": 16, "pdrop": 0.5,
                               "reg": {"maxnorm": 0.9}}],
              ["SoftmaxLayer", {"n_out": 10}]]
    tr = {"SEED": 5, "BATCH_SZ": B, "NUM_EPOCHS": 1, "EPOCHS_TO_TEST": 1,
          "TEST_SAMP_SZ": B, "INIT_LEARNING_RATE": 0.1,
          "EPOCHS_TO_HALF_RATE": 1, "MEGAFUSED": True}
    rng = np.random.RandomState(8)
    x = rng.rand(nb * B, 1, 12, 12).astype(np.float32)
    y = rng.randint(0, 10, nb * B).astype(np.int32)
    tnet = TorchNet([[n, dict(a)] for n, a in layers], dict(tr))
    trainer = Trainer(tnet, x, y, x[:B], y[:B], device="cpu")
    ts = trainer._mega_spec
    assert trainer._mega_plan.epoch_fn is megastep.megastep_epoch
    assert ts.batch == B and megastep.flagship_head_smem(ts) == 50400
    js = jmega.spec_from_net(JaxNet([[n, dict(a)] for n, a in layers],
                                    dict(tr)))
    assert (js.batch, js.n_tiles, js.loss_div) == (30, 20, B)

    aw = [[np.asarray(w, np.float32) for w in tnet.allwts0[i]]
          for i in trainer._mega_plan.layer_idx]
    words = jmega.epoch_noise_bits(jax.random.PRNGKey(3), js, nb)
    ub, fb, pb, db = (np.asarray(w).view(np.int32) for w in words)
    bits = (torch.tensor(ub), torch.tensor(fb),
            torch.tensor(pb).reshape(nb, B, ts.hw),
            torch.tensor(db).reshape(nb, B, -1))
    fn = jmega.make_epoch_fn(js, nb, interpret=True)
    jp = [jnp.asarray(t) for t in jmega.params_to_kernel(aw, js)]
    jp, jm_, jcm = fn(jp, [jnp.zeros_like(t) for t in jp], jnp.asarray(x),
                      jnp.asarray(y[:, None]), words, 0.1)
    tp = megastep.kernel_layout([[torch.tensor(w) for w in lw] for lw in aw],
                                ts)
    xs = torch.tensor(x).reshape(nb, B, ts.hw)
    tp, tm_, tcm = megastep.megastep_epoch(
        tp, [torch.zeros_like(t) for t in tp], xs,
        torch.tensor(y).reshape(nb, B), bits, 0.1, ts)
    np.testing.assert_allclose(tcm[:, 0].numpy(), np.asarray(jcm)[:, 0],
                               rtol=1e-4)
    np.testing.assert_allclose(tcm[:, 1].numpy(), np.asarray(jcm)[:, 1],
                               atol=1e-4)
    for a, b in zip(jp + jm_, tp + tm_):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4)

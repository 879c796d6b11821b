"""Which fused family takes a net, in the port and in the JAX package.

The port's matchers decline, by name, every spec its CUDA kernels would
refuse at launch (a head stage or a warp field beyond a block's shared
memory), so a net takes the same route on the CPU and on a card. bench.py's
wide model (batch 256, 1000 classes) is declined by both packages; every
shipped .prms keeps its family; bf16 does not stop a net from fusing.
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
    net = TorchNet(*chip_smoke.wide_spec(dtype, img=12))
    assert megastep.fused_plan(net) is None
    reason = megastep.fused_decline_reason(net)
    assert "head kernel's shared memory" in reason, reason
    assert "BATCH_SZ 256 x 1000" in reason, reason


def test_jax_declines_the_wide_model_too():
    net = JaxNet(*chip_smoke.wide_spec(None, img=12))
    assert jmega.fused_plan(net) is None


@pytest.mark.parametrize("n_out,fuses", [(306, True), (307, False)])
def test_flagship_head_limit_is_the_kernels(n_out, fuses):
    """csrc/megastep.cu takes a head of (2 B NC + B) floats up to 48 KB:
    at batch 20, 306 classes and not 307 (the deep family's head is larger,
    so it declines too)."""
    net = TorchNet(*chip_smoke.wide_spec(None, img=12, batch=20, maps=(2, 3),
                                         n_hid=8, n_out=n_out))
    spec = megastep.spec_from_net(net)
    assert (spec is not None) == fuses
    if fuses:
        assert megastep.flagship_head_smem(spec) <= 48 * 1024
        assert megastep.fused_plan(net).epoch_fn is megastep.megastep_epoch
    else:
        assert megastep.fused_plan(net) is None
        assert "head kernel's shared memory" in megastep.fused_decline_reason(
            net)


@pytest.mark.parametrize("n_out,fuses", [(16, True), (512, False)])
def test_flat_head_limit_is_the_deep_kernels(n_out, fuses):
    """The flat-MLP family runs the deep kernel, whose head holds (2 B NO +
    B NC + NC + 4 B) floats: both matchers decline past 48 KB."""
    layers = [["InputLayer", {"img_sz": 6}],
              ["HiddenLayer", {"n_out": 8}],
              ["SoftmaxLayer", {"n_out": n_out}]]
    net = TorchNet(layers, small_prms(20))
    dspec = mlp.as_deep(mlp.MlpSpec(
        batch=20, img=6, n_hid=8, n_out=n_out, slope_h=0.01, pdrop=0.0,
        translation=0, zoom=1, magnitude=0, sigma=1, pflip=0.0, angle=0,
        invert=False, nearest=False, reg_h=None, reg_o=None))
    assert (deep.deep_head_smem(dspec) <= 48 * 1024) == fuses
    plan = megastep.fused_plan(net)
    assert (plan is not None) == fuses
    if fuses:
        assert plan.epoch_fn is mlp.mlp_epoch
    else:
        assert "megastep_deep.cu" in megastep.fused_decline_reason(net)


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
           "flat_mlp": ("synth_hard", "mlp_epoch")}


def shipped_layers(name):
    layers, tr, _ = load_params(os.path.join(REPO, "params", name + ".prms"))
    data = importlib.import_module("theanet_tpu_torch.data."
                                   + SHIPPED[name][0])
    shape = fixdim(data.training_x[:1]).shape
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
    """synth_aux's SoftAux head is not ported: the port refuses it when
    the net is built, so no route is taken."""
    names = sorted(f[:-5] for f in os.listdir(os.path.join(REPO, "params"))
                   if f.endswith(".prms"))
    assert sorted(list(SHIPPED) + ["synth_aux"]) == names
    layers, tr, _ = load_params(os.path.join(REPO, "params",
                                             "synth_aux.prms"))
    layers[0][1]["img_sz"] = 28
    with pytest.raises(NotImplementedError):
        TorchNet(layers, tr)


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

"""The port's copies of the JAX package's numpy modules stay bit-equal.

theanet_tpu_torch cannot import theanet_tpu (its __init__ imports JAX, and
the machine with the GPU has none), so inits.py, prms.py and the dataset
generators are copies. Same SEED -> the same initial weights; same module
name -> the same dataset arrays.
"""

import numpy as np
import pytest
import torch

from theanet_tpu import activations as jax_acts
from theanet_tpu.data import synth as jax_synth
from theanet_tpu.data import synth3 as jax_synth3
from theanet_tpu.data import synth_hard as jax_synth_hard
from theanet_tpu.model import NeuralNet as JaxNet
from theanet_tpu.prms import load_params as jax_load_params

from theanet_tpu_torch import activations as torch_acts
from theanet_tpu_torch.data import load_dataset
from theanet_tpu_torch.data import synth as torch_synth
from theanet_tpu_torch.data import synth3 as torch_synth3
from theanet_tpu_torch.data import synth_hard as torch_synth_hard
from theanet_tpu_torch.model import NeuralNet as TorchNet
from theanet_tpu_torch.prms import fixdim, load_params


@pytest.mark.parametrize("seed", [0, 99, 123456])
def test_mnist_cnn_init_is_bit_equal(seed):
    layers, tr, _ = load_params("params/mnist_cnn.prms")
    jlayers, jtr, _ = jax_load_params("params/mnist_cnn.prms")
    for lay, t in ((layers, tr), (jlayers, jtr)):
        lay[0][1]["img_sz"] = 28
        t["SEED"] = seed
    ours, ref = TorchNet(layers, tr).allwts0, JaxNet(jlayers, jtr).allwts0
    assert len(ours) == len(ref) == 7
    for lo, lr in zip(ours, ref):
        assert len(lo) == len(lr)
        for a, b in zip(lo, lr):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _shipped_nets(name, n_maps, seed, **color):
    out = []
    for load, cls in ((load_params, TorchNet), (jax_load_params, JaxNet)):
        layers, tr, _ = load(f"params/{name}.prms")
        layers[0][1].update(img_sz=28, **color)
        if n_maps != 1:
            layers[0][1]["num_maps"] = n_maps
        tr["SEED"] = seed
        out.append(cls(layers, tr).allwts0)
    return out


@pytest.mark.parametrize("name,n_maps", [("galaxy_rbf", 3),
                                         ("logit_centered", 1)])
def test_centered_configs_init_is_bit_equal(name, n_maps):
    """Every drawn tensor, the CenteredOut centers included (uniform for
    RBF after the weights, binomial for LOGIT), and galaxy_rbf's
    ColorLayer stream-seed draw before them all."""
    ours, ref = _shipped_nets(name, n_maps, 4321)
    assert len(ours) == len(ref)
    for lo, lr in zip(ours, ref):
        assert len(lo) == len(lr)
        for a, b in zip(lo, lr):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    centers = ours[-1][2]
    assert centers.shape == (10, 32 if name == "galaxy_rbf" else 24)
    if name == "logit_centered":
        assert set(np.unique(centers)) <= {0.0, 1.0}
    else:
        # an identity ColorLayer draws no stream seed, so the conv weights
        # after it come from an earlier point of the stream
        ident, jident = _shipped_nets(name, n_maps, 4321, balance=1, gamma=1)
        np.testing.assert_array_equal(ident[2][0], jident[2][0])
        assert not np.array_equal(ident[2][0], ours[2][0])


def test_dropout_layer_consumes_the_stream_seed():
    """A DropOut layer draws one stream seed (reference dropout.py:10-11);
    the weights after it must still match."""
    layers = [["InputLayer", {"img_sz": 8}],
              ["HiddenLayer", {"n_out": 6, "pdrop": 0.3}],
              ["DropOutLayer", {"pdrop": 0.2}],
              ["HiddenLayer", {"n_out": 5, "actvn": "relu"}],
              ["SoftmaxLayer", {"n_out": 3}]]
    tr = {"SEED": 7, "BATCH_SZ": 2}
    ours = TorchNet([list(l) for l in layers], dict(tr)).allwts0
    ref = JaxNet([list(l) for l in layers], dict(tr)).allwts0
    for lo, lr in zip(ours, ref):
        for a, b in zip(lo, lr):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,mine,theirs", [
    ("synth", torch_synth, jax_synth),
    ("synth_hard", torch_synth_hard, jax_synth_hard),
    ("synth3", torch_synth3, jax_synth3),
])
def test_dataset_arrays_are_bit_equal(name, mine, theirs):
    for attr in ("training_x", "training_y", "testing_x", "testing_y"):
        a, b = getattr(mine, attr), getattr(theirs, attr)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert load_dataset(name) is mine


def test_fixdim_shapes():
    assert fixdim(np.zeros((3, 16))).shape == (3, 1, 4, 4)
    assert fixdim(np.zeros((3, 4, 4))).shape == (3, 1, 4, 4)
    assert fixdim(np.zeros((3, 2, 4, 4))).shape == (3, 2, 4, 4)


@pytest.mark.parametrize("name", ["relu", "relu00", "relu05", "relu10",
                                  "relu99", "linear", "tanh", "scaled_tanh",
                                  "sigmoid", "softplus", "softmax"])
def test_activation_registry_matches(name):
    x = np.linspace(-3, 3, 24, dtype=np.float32).reshape(2, 12)
    got = torch_acts.activation_by_name(name)(torch.tensor(x)).numpy()
    want = np.asarray(jax_acts.activation_by_name(name)(x))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert set(torch_acts.ACTIVATIONS) == set(jax_acts.ACTIVATIONS)
    with pytest.raises(NotImplementedError):
        torch_acts.activation_by_name("relu100x")

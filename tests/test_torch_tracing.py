"""The port's spans (``theanet_tpu_torch/tracing.py``) and the Trainer's
host-read counter on the CPU: the recorder on its own, the span tree a
Trainer round records on the fused plain twin and on the per-layer path,
and the reads a round makes."""

import numpy as np
import pytest
import torch

from theanet_tpu_torch import tracing
from theanet_tpu_torch.model import NeuralNet
from theanet_tpu_torch.ops import _build
from theanet_tpu_torch.trainer import Trainer

B, IMG, NC = 4, 12, 4


def _depths(records):
    """[(name, depth)] of ``records`` in their order."""
    depth = []
    for _, _, _, parent in records:
        depth.append(0 if parent < 0 else depth[parent] + 1)
    return [(r[0], d) for r, d in zip(records, depth)]


@pytest.fixture
def recorder():
    """The process's recorder, on, and off and empty again after."""
    tracing.take()
    tracing.enable(True)
    yield tracing.RECORDER
    tracing.enable(False)
    tracing.take()


def test_disabled_span_is_one_shared_noop():
    rec = tracing.Recorder()
    first = rec.span("a")
    assert rec.span("b") is first
    with rec.span("a"):
        with rec.span("b"):
            pass
    assert rec.take() == [] and rec.dropped == 0
    assert tracing.span("x") is first


def test_nested_spans_record_parents_and_self_time():
    rec = tracing.Recorder()
    rec.enable(True)
    with rec.span("outer"):
        with rec.span("a"):
            with rec.span("a.1"):
                pass
        with rec.span("b"):
            pass
    with rec.span("second"):
        pass
    got = rec.take()
    assert [(n, p) for n, _, _, p in got] == [
        ("outer", -1), ("a", 0), ("a.1", 1), ("b", 0), ("second", -1)]
    for name, start, end, parent in got:
        assert start <= end
        if parent >= 0:
            assert got[parent][1] <= start and end <= got[parent][2]
    starts = [r[1] for r in got]
    assert starts == sorted(starts)
    own = tracing.self_ns(got)
    length = [e - s for _, s, e, _ in got]
    assert own[0] == length[0] - length[1] - length[3]
    assert own[1] == length[1] - length[2]
    assert own[2] == length[2] and own[4] == length[4]
    assert rec.take() == []


def test_full_buffer_drops_and_counts(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    rec = tracing.Recorder()
    rec.enable(True)
    with rec.span("a"):
        with rec.span("b"):
            pass
    with rec.span("c"):
        with rec.span("dropped"):
            with rec.span("dropped too"):
                pass
    with rec.span("dropped as well"):
        pass
    assert [r[0] for r in rec.take()] == ["a", "b", "c"]
    assert rec.dropped == 3
    with rec.span("d"):
        pass
    assert [r[0] for r in rec.take()] == ["d"]
    rec.enable(False)
    rec.enable(True)
    assert rec.dropped == 0


def test_take_while_a_span_is_open():
    rec = tracing.Recorder()
    rec.enable(True)
    with rec.span("open"):
        first = rec.take()
        with rec.span("child"):
            pass
    assert first[0][0] == "open" and first[0][2] is None
    assert [(n, p) for n, _, _, p in rec.take()] == [("child", -1)]


def test_span_ends_when_its_body_raises():
    rec = tracing.Recorder()
    rec.enable(True)
    with pytest.raises(KeyError):
        with rec.span("outer"):
            with rec.span("inner"):
                raise KeyError("x")
    with rec.span("after"):
        pass
    got = rec.take()
    assert [(n, p) for n, _, _, p in got] == [
        ("outer", -1), ("inner", 0), ("after", -1)]
    assert all(end is not None for _, _, end, _ in got)


def test_profiler_range_only_while_a_profiler_records():
    rec = tracing.Recorder()
    rec.enable(True)
    with rec.span("quiet") as quiet:
        assert quiet.func is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("loud"):
            pass
    names = {e.name for e in prof.events()}
    assert "theanet.loud" in names and "theanet.quiet" not in names
    assert [r[0] for r in rec.take()] == ["quiet", "loud"]


def _flagship_trainer(mode):
    """A tiny net of mnist_cnn's shape (Elastic, two conv-pool stages, a
    hidden layer, softmax: 8 state tensors) on the CPU."""
    layers = [["ElasticLayer", {"img_sz": IMG, "translation": 2,
                                "zoom": 1.1, "magnitude": 8, "sigma": 3,
                                "pflip": 0.03, "angle": 5, "nearest": True,
                                "invert_image": True}],
              ["ConvLayer", {"num_maps": 2, "filter_sz": 3, "stride": 1,
                             "actvn": "relu10"}],
              ["PoolLayer", {"pool_sz": 2}],
              ["ConvLayer", {"num_maps": 3, "filter_sz": 3, "stride": 1,
                             "actvn": "relu05"}],
              ["PoolLayer", {"pool_sz": 2}],
              ["HiddenLayer", {"n_out": 16, "pdrop": 0.5}],
              ["SoftmaxLayer", {"n_out": NC}]]
    tr = {"SEED": 3, "BATCH_SZ": B, "MEGAFUSED": mode,
          "INIT_LEARNING_RATE": 0.1, "EPOCHS_TO_HALF_RATE": 1}
    rng = np.random.RandomState(6)
    x = rng.rand(3 * B, 1, IMG, IMG).astype(np.float32)
    y = rng.randint(0, NC, 3 * B).astype(np.int32)
    t = Trainer(NeuralNet(layers, tr), x, y, x[:2 * B], y[:2 * B],
                device="cpu")
    assert (t._mega is not None) == (mode == "auto")
    return t


def _round(trainer, path, n_epochs=2):
    """One round of the CLI's loop: the epochs, two eval windows and the
    checkpoint."""
    trainer.snapshot_state()
    trainer.run_epochs(n_epochs)
    trainer.evaluate("test", [0, 1])
    trainer.evaluate("train", [1, 2])
    trainer.save_checkpoint(str(path))


FUSED_TREE = [
    ("trainer.snapshot_state", 0),
    ("trainer.run_epochs", 0),
    ("trainer.epoch", 1), ("trainer.to_kernel", 2), ("trainer.noise_bits", 2),
    ("trainer.epoch", 1), ("trainer.noise_bits", 2),
    ("trainer.read_costs", 1),
    ("trainer.evaluate", 0), ("trainer.sync_frame", 1),
    ("trainer.eval_forward", 1), ("trainer.eval_read", 1),
    ("trainer.evaluate", 0),
    ("trainer.eval_forward", 1), ("trainer.eval_read", 1),
    ("trainer.save_checkpoint", 0),
    ("net.snapshot_params", 1), ("checkpoint.write", 1)]

PER_LAYER_TREE = [
    ("trainer.snapshot_state", 0),
    ("trainer.run_epochs", 0),
    ("trainer.epoch", 1), ("trainer.read_costs", 2),
    ("trainer.epoch", 1), ("trainer.read_costs", 2),
    ("trainer.evaluate", 0),
    ("trainer.eval_forward", 1), ("trainer.eval_read", 1),
    ("trainer.evaluate", 0),
    ("trainer.eval_forward", 1), ("trainer.eval_read", 1),
    ("trainer.save_checkpoint", 0),
    ("net.snapshot_params", 1), ("checkpoint.write", 1)]


@pytest.mark.parametrize("mode,tree", [("auto", FUSED_TREE),
                                       (False, PER_LAYER_TREE)])
def test_trainer_round_records_the_span_tree(mode, tree, recorder,
                                             tmp_path):
    """The fused plain twin has no C call, so no ``fused.launch``."""
    trainer = _flagship_trainer(mode)
    _round(trainer, tmp_path / "a.pkl")
    got = tracing.take()
    assert _depths(got) == tree
    assert all(s <= e for _, s, e, _ in got)
    _round(trainer, tmp_path / "b.pkl")
    again = _depths(tracing.take())
    if mode == "auto":
        # the state stays in the kernel layout between rounds
        assert again == [t for t in tree if t[0] != "trainer.to_kernel"]
    else:
        assert again == tree


@pytest.mark.parametrize("mode,reads", [("auto", 13), (False, 14)])
def test_host_reads_of_a_round(mode, reads, tmp_path):
    """mnist_cnn's shape: one cost read (the per-layer path reads costs
    and minima apart), two statistics an eval window, 8 tensors to
    snapshot; 2 more for predict's features and predictions."""
    trainer = _flagship_trainer(mode)
    _round(trainer, tmp_path / "a.pkl", n_epochs=1)
    assert trainer.host_reads == reads
    _round(trainer, tmp_path / "b.pkl", n_epochs=1)
    assert trainer.host_reads == 2 * reads
    trainer.predict(np.zeros((B, 1, IMG, IMG), np.float32))
    assert trainer.host_reads == 2 * reads + 2


def test_epoch_entry_span_holds_the_c_call(recorder, monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "_workspace",
                        lambda *a: torch.empty(0))
    monkeypatch.setattr(_build, "_entry",
                        lambda prefix, lib, entry, *a, dev: calls.append(
                            (entry, len(tracing.RECORDER._open))))
    assert _build._run("megastep", None, None, None, [], 1, 0.1,
                       torch.device("cpu")) == 0
    assert calls == [("epoch", 1)]
    assert _depths(tracing.take()) == [("fused.launch", 0)]

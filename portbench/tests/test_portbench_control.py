"""The comparison refuses the control and every fault a training cell can
have, at a size the CPU holds; sound runs pass.

The control is the reference in TF32 in the program's place. The faults
are planted in the program underneath a whole run (the harness's look for
a chip skipped): an epoch that returns its state unchanged, half of each
batch left out (the mean over the rest), the LR schedule stuck at epoch
0's rate, epoch 0's noise words drawn every epoch, an eval answer altered
where it is produced. The exchange between chips does not exist in
one-chip cells."""

import pytest
import torch

from portbench import calibrate, cells, compare, harness

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_and_stand_in_faults_fail_and_program_passes(cell, small):
    rows = calibrate.calibrate(cell, [2 ** 31 + 3], seconds=0.0,
                               device="cpu", out=open("/dev/null", "w"))
    limits = cells.cell(cell)["limits"]
    by = {r["reading"]: r for r in rows}
    assert compare.checks(by["program"], limits)[1]
    assert compare.checks(by["witness"], limits)[1]
    for fault in ("control", "half_batch", "lr_epoch0", "noise_epoch0"):
        assert not compare.checks(by[fault], limits)[1], fault


def _unchanged(fn):
    def epoch(kparams, kmoms, x, y, bits, lr, spec, **kw):
        _, _, cm = fn(kparams, kmoms, x, y, bits, lr, spec, **kw)
        return ([t.clone() for t in kparams], [t.clone() for t in kmoms], cm)
    return epoch


def _half_batch(fn):
    def epoch(kparams, kmoms, x, y, bits, lr, spec, **kw):
        B, h = spec.batch, spec.batch // 2
        x = x.reshape(x.shape[0], -1, B, x.shape[-1]).clone()
        x[:, :, h:2 * h] = x[:, :, :h]
        y = y.clone()
        y[:, h:2 * h] = y[:, :h]
        return fn(kparams, kmoms, x.reshape(x.shape[0], -1, x.shape[-1])
                  .contiguous(), y, bits, lr, spec, **kw)
    return epoch


def _run(cell):
    return harness.run(cell, 2 ** 31 + 17, 0.3, False, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_epoch_faults_make_correct_false(cell, fault, small, monkeypatch):
    from theanet_tpu_torch.ops import megastep

    wrap = {"unchanged": _unchanged, "half_batch": _half_batch}[fault]
    monkeypatch.setattr(megastep, "megastep_epoch",
                        wrap(megastep.megastep_epoch))
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_rate_stuck_at_epoch_0_makes_correct_false(cell, small,
                                                   monkeypatch):
    from theanet_tpu_torch.model import NeuralNet

    monkeypatch.setattr(NeuralNet, "get_rate",
                        lambda self: self.tr_prms["INIT_LEARNING_RATE"])
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_epoch_0_noise_every_epoch_makes_correct_false(cell, small,
                                                       monkeypatch):
    from theanet_tpu_torch.ops import megastep

    real = megastep.epoch_noise_bits

    def bits(seed, epoch, *args, **kw):
        return real(seed, 0, *args, **kw)

    monkeypatch.setattr(megastep, "epoch_noise_bits", bits)
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_altered_eval_answer_makes_correct_false(cell, small, monkeypatch):
    from theanet_tpu_torch.trainer import Trainer

    real = Trainer.evaluate

    def evaluate(self, which, batch_ids, preds_feats=False):
        err, p = real(self, which, batch_ids)
        return err + 100.0 / (len(batch_ids) * self.batch_sz), p

    monkeypatch.setattr(Trainer, "evaluate", evaluate)
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, small):
    assert _run(cell)["correct"] is True


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from portbench.reference import TF32

    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -1.0 - 2 ** -12], dtype=torch.float32)
    assert TF32.r(x).tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0]

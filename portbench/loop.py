"""The training CLI's loop, as the benchmark drives it.

A copy of ``theanet_tpu_torch/train.py``'s epoch loop (its ``_run``, from
the chunking to the rotating eval windows and the keep-one checkpoint),
driving the port's ``Trainer`` one round at a time: a round runs the
epochs up to the next test boundary as one ``Trainer.run_epochs`` call,
then, at the boundary, ``Trainer.evaluate('test', window)``,
``Trainer.evaluate('train', window)`` and ``Trainer.save_checkpoint``,
deleting the previous checkpoint, as the CLI does. The CLI's epoch table
is formatted as there, into a sink that is dropped. A NaN cost raises,
as the CLI's does (without its replay to the failing epoch and its weight
dump, which only a failing run reaches), and the ExpLoss head's
divergence dump is left out: no configuration of the benchmark has that
head.

Each round records host spans ``(name, start, end)`` on
``time.perf_counter`` around the calls it makes into the Trainer, and the
same names as ``torch.profiler.record_function`` ranges, so a profiled
round carries them in the device trace.
"""

from __future__ import annotations

import io
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np


def get_test_indices(tot_samps, batch_sz, bth_samps):
    """Rotating-window eval batch-id generator (a copy of the port's
    ``trainer.get_test_indices``; reference train.py:170-176)."""
    n_bths_each = int(bth_samps / batch_sz)
    n_bths_all = int(tot_samps / batch_sz)
    cur = 0
    while True:
        yield [i % n_bths_all for i in range(cur, cur + n_bths_each)]
        cur = (cur + n_bths_each) % n_bths_all


@dataclass
class Round:
    epochs: int                # epochs trained in the round
    steps: int                 # training steps
    costs: np.ndarray          # (epochs, steps an epoch) step costs
    start: float = 0.0
    end: float = 0.0
    spans: list = field(default_factory=list)
    boundary: dict = None      # the test boundary's windows and statistics
    ckpt_bytes: int = 0

    @property
    def period_s(self):
        return self.end - self.start


class Loop:
    """``train.py``'s loop over a constructed ``trainer``, its net's
    training params ``tr`` and a checkpoint directory. ``sync_boundary``
    ends each test boundary with ``torch.cuda.synchronize()`` so its span
    holds its device work (the traced run)."""

    def __init__(self, trainer, tr, ckpt_dir, out_file_head,
                 sync_boundary=False):
        self.trainer = trainer
        self.batch_sz = tr["BATCH_SZ"]
        self.epochs_to_test = tr["EPOCHS_TO_TEST"]
        self.n_epochs = tr["NUM_EPOCHS"]
        self.test_indices = get_test_indices(
            trainer.d_test_x.shape[0], self.batch_sz, tr["TEST_SAMP_SZ"])
        self.trin_indices = get_test_indices(
            trainer.d_train_x.shape[0], self.batch_sz, tr["TEST_SAMP_SZ"])
        self.pickle_file_name = os.path.join(
            ckpt_dir, out_file_head + "_{:02.0f}.pkl")
        self.saved_file_name = None
        self.sync_boundary = sync_boundary
        self.epoch = 0
        self.sink = io.StringIO()
        self._spans = None

    @contextmanager
    def span(self, name):
        import torch

        with torch.profiler.record_function("portbench." + name):
            t0 = time.perf_counter()
            yield
            self._spans.append((name, t0, time.perf_counter()))

    def _do_test(self):
        import torch

        trainer = self.trainer
        test_ids, trin_ids = next(self.test_indices), next(self.trin_indices)
        with self.span("test_boundary"):
            with self.span("evaluate_test"):
                test_err, aux_test_err = trainer.evaluate("test", test_ids)
            with self.span("evaluate_train"):
                trin_err, aux_trin_err = trainer.evaluate("train", trin_ids)
            print("{:5.2f}%  ({:5.2f}%)      {:5.2f}%  ({:5.2f}%)".format(
                trin_err, aux_trin_err, test_err, aux_test_err),
                file=self.sink)
            with self.span("save_checkpoint"):
                if self.saved_file_name:
                    os.remove(self.saved_file_name)
                self.saved_file_name = self.pickle_file_name.format(test_err)
                trainer.save_checkpoint(self.saved_file_name)
            if self.sync_boundary:
                torch.cuda.synchronize()
        return dict(test_ids=test_ids, train_ids=trin_ids,
                    test=(test_err, aux_test_err),
                    train=(trin_err, aux_trin_err),
                    ckpt_bytes=os.path.getsize(self.saved_file_name))

    def round(self):
        """One round of the CLI's loop: the chunk of epochs up to the next
        test boundary (or the final epoch), then the boundary's eval and
        checkpoint when the chunk ends on one."""
        trainer, epoch, ett = self.trainer, self.epoch, self.epochs_to_test
        self.sink.seek(0)
        self.sink.truncate()
        self._spans = []
        if epoch % ett == 0:
            chunk_end = epoch
        else:
            chunk_end = min((epoch // ett + 1) * ett, self.n_epochs - 1)
        chunk_len = chunk_end - epoch + 1
        start = time.perf_counter()
        test_row_epoch = trainer.net.get_epoch() + chunk_len - 1
        with self.span("epochs"):
            with self.span("snapshot_state"):
                trainer.snapshot_state()
            with self.span("run_epochs"):
                totals, costs2d, _ = trainer.run_epochs(chunk_len)
        for j in range(chunk_len):
            if np.isnan(totals[j]):
                raise FloatingPointError(
                    "Nan cost at Epoch:{} Iteration:{}".format(
                        epoch + j, int(np.argmax(np.isnan(costs2d[j])))))
        total_cost = float(totals[-1])
        boundary = None
        if (epoch + chunk_len - 1) % ett == 0:
            print("{:3d} {:>8.2f}".format(test_row_epoch, total_cost),
                  end="    ", file=self.sink)
            boundary = self._do_test()
            if total_cost > 1e6:
                trainer.sync_net()
                print(trainer.net.get_wts_info(detailed=True),
                      file=self.sink)
        self.epoch += chunk_len
        return Round(epochs=chunk_len, steps=chunk_len * costs2d.shape[1],
                     costs=costs2d, start=start, end=time.perf_counter(),
                     spans=self._spans, boundary=boundary,
                     ckpt_bytes=boundary["ckpt_bytes"] if boundary else 0)

    def close(self):
        if self.saved_file_name and os.path.exists(self.saved_file_name):
            os.remove(self.saved_file_name)

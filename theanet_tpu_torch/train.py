"""Training CLI: ``python -m theanet_tpu_torch.train <dataset> <prms|pkl>
[redirect]`` (port of ``theanet_tpu/train.py``; reference train.py:59-245).

  * args: dataset module name, a .prms config or a .pkl checkpoint to
    resume, optional trailing '1' to tee the log to <head>_<SEED>.txt;
  * prints the banner, layer/param/weight info, then the epoch table
    ``Epoch Cost Tr_Error Tr_P(MLE) Te_Error Te_P(MLE)`` (BitErr in place
    of P(MLE) for a LOGIT CenteredOut head);
  * rotating-window eval every EPOCHS_TO_TEST epochs; the checkpoint
    <head>_<SEED>_<testerr>.pkl replaces the previous one;
  * NaN-cost abort with a weight dump, the ExpLoss head's divergence dump
    (the smallest true-class score of an epoch below -6; on the fused path
    the kernel's per-step minimum), the high-cost weight dump, and the
    final full-dataset row (cost printed as 0 by protocol);
  * a data module's ``training_aux`` / ``testing_aux`` (n, 2, 2) reach a
    net with an aux layer.

Epochs between two test rows run as one ``Trainer.run_epochs`` call with a
single host sync; a NaN or an ExpLoss divergence inside such a chunk
rewinds to the chunk start and replays to the failing epoch, so the dump
shows the at-failure weights.
The device comes from THEANET_TORCH_DEVICE (default cuda).
THEANET_PROFILE_DIR=<dir> profiles the round that trains epoch 1 and its
test boundary with ``torch.profiler`` (CPU activity, and CUDA activity on
a card), with the port's spans on (``tracing.py``: ``theanet.*`` ranges
beside the kernels), and writes the Chrome trace to
``<dir>/<head>_epoch1.json``, naming the file on stderr beside the
round's spans by self time, its count of blocking device-to-host
reads (``Trainer.host_reads``) and the deep family's tiled input- and
weight-gradient launches in the round (``deep_epoch.dgrad_tiled_launches``,
``deep_epoch.wgrad_tiled_launches``). The JAX CLI's
THEANET_STEPWISE=1 is not ported: set, it stops the run with an error that
names it.
"""

from __future__ import annotations

import contextlib
import os
import socket
import sys
import time
from datetime import datetime

import numpy as np
import torch

from . import tracing
from .data import load_dataset
from .device import default_device
from .model import NeuralNet, get_layers_info, get_training_params_info
from .prms import fixdim, load_params
from .trainer import Trainer, get_test_indices


class OutputLog:
    """stdout replacement that optionally writes the epoch protocol to a
    line-buffered log file; ``checkpoint_flush`` makes it durable at every
    test interval."""

    def __init__(self, path: str | None = None):
        self._file = open(path, "w", buffering=1) if path else None
        self._console = sys.stdout

    @property
    def _target(self):
        return self._file if self._file is not None else self._console

    def write(self, text):
        return self._target.write(text)

    def checkpoint_flush(self):
        if self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def __getattr__(self, attr):
        return getattr(self._target, attr)


def _refuse_unported_switches():
    """The JAX CLI's THEANET_STEPWISE=1 (per-batch steps) is not ported:
    the run stops and names the switch rather than train without it."""
    if os.environ.get("THEANET_STEPWISE") == "1":
        raise NotImplementedError(
            "THEANET_STEPWISE is not ported yet (ROADMAP.md queue 1 item 3)")


@contextlib.contextmanager
def _profiled(device, trainer, profile_dir, head):
    """Profile the block with torch.profiler and the port's spans on. If
    the block ends normally, write the Chrome trace, and print on stderr
    its path, each span name's calls and self time (host clock, profiler
    on), the block's blocking device-to-host reads and the deep family's
    tiled input- and weight-gradient launches. Profiler and spans stop
    however the block ends."""
    from torch.profiler import ProfilerActivity, profile

    from .ops.megastep_deep import deep_epoch

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    reads = trainer.host_reads
    tiled = deep_epoch.dgrad_tiled_launches
    wtiled = deep_epoch.wgrad_tiled_launches
    with profile(activities=acts) as prof:
        tracing.take()
        tracing.enable(True)
        try:
            yield
        finally:
            tracing.enable(False)
            records = tracing.take()
    reads = trainer.host_reads - reads
    tiled = deep_epoch.dgrad_tiled_launches - tiled
    wtiled = deep_epoch.wgrad_tiled_launches - wtiled
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, head + "_epoch1.json")
    prof.export_chrome_trace(path)
    print("profiler trace written to", path, file=sys.stderr)
    calls, own = {}, {}
    for (name, *_), ns in zip(records, tracing.self_ns(records)):
        calls[name] = calls.get(name, 0) + 1
        own[name] = own.get(name, 0) + ns
    print("span self times of the profiled round (calls, ms):",
          file=sys.stderr)
    for name in sorted(own, key=own.get, reverse=True):
        print("  {:<24s} {:4d} {:10.3f}".format(name, calls[name],
                                                own[name] / 1e6),
              file=sys.stderr)
    if tracing.RECORDER.dropped:
        print("  ({} spans dropped)".format(tracing.RECORDER.dropped),
              file=sys.stderr)
    print("host reads in the profiled round:", reads, file=sys.stderr)
    print("tiled input-gradient launches in the profiled round:", tiled,
          file=sys.stderr)
    print("tiled weight-gradient launches in the profiled round:", wtiled,
          file=sys.stderr)


def main(argv=None):
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 3:
        print(
            f"Usage: {argv[0]} <dataset> <config.prms | checkpoint.pkl> "
            "[redirect]\n\n"
            "  dataset    data module name; resolved as data.<name> first,\n"
            "             then theanet_tpu_torch.data.<name>\n"
            "  .prms      fresh run from a Python-literal config dict\n"
            "  .pkl       resume training from a saved checkpoint\n"
            "  redirect   pass 1 to write the epoch log to "
            "<config>_<SEED>.txt\n")
        sys.exit(1)

    _refuse_unported_switches()
    dataset_name, prms_file_name = argv[1], argv[2]
    layers, tr_prms, allwts = load_params(prms_file_name)
    out_file_head = os.path.basename(prms_file_name).replace(
        os.path.splitext(prms_file_name)[1], "_{:06d}".format(tr_prms["SEED"]))

    console = sys.stdout
    log = OutputLog(out_file_head + ".txt" if argv[-1] == "1" else None)
    if argv[-1] == "1":
        print("Printing output to {}.txt".format(out_file_head),
              file=sys.stderr)
    sys.stdout = log
    try:
        return _run(argv, dataset_name, layers, tr_prms, allwts,
                    out_file_head, log)
    finally:
        sys.stdout = console
        log.close()


def _run(argv, dataset_name, layers, tr_prms, allwts, out_file_head, log):
    device = default_device()
    print(" ".join(argv), file=sys.stderr)
    print(" ".join(argv))
    print("Time   :" + datetime.now().strftime("%Y-%m-%d %H:%M:%S"))
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print("Device : {} ({})".format(device.type, kind))
    print("Host   :", socket.gethostname())
    print(get_layers_info(layers))
    print(get_training_params_info(tr_prms))

    data = load_dataset(dataset_name)
    training_x = fixdim(data.training_x)
    testing_x = fixdim(data.testing_x)
    tr_corpus_sz, n_maps, _, img_sz = training_x.shape
    te_corpus_sz = testing_x.shape[0]
    layers[0][1]["img_sz"] = img_sz
    if "num_maps" not in layers[0][1] and n_maps != 1:
        layers[0][1]["num_maps"] = n_maps

    print("\nInitializing the net ... ")
    net = NeuralNet(layers, tr_prms, allwts)
    print(net)
    print(net.get_wts_info(detailed=True).replace("\n\t", ""))

    print("\nCompiling ... ")
    trainer = Trainer(net, training_x, data.training_y, testing_x,
                      data.testing_y, device=device,
                      train_aux=getattr(data, "training_aux", None),
                      test_aux=getattr(data, "testing_aux", None))
    batch_sz, n_epochs = tr_prms["BATCH_SZ"], tr_prms["NUM_EPOCHS"]
    # a LOGIT head's second statistic is its true-class bit error
    aux_err_name = ("BitErr" if getattr(net.head, "kind", None) == "LOGIT"
                    else "P(MLE)")
    test_indices = get_test_indices(te_corpus_sz, batch_sz,
                                    tr_prms["TEST_SAMP_SZ"])
    trin_indices = get_test_indices(tr_corpus_sz, batch_sz,
                                    tr_prms["TEST_SAMP_SZ"])
    pickle_file_name = out_file_head + "_{:02.0f}.pkl"
    saved_file_name = None

    def do_test():
        nonlocal saved_file_name
        test_err, aux_test_err = trainer.evaluate("test", next(test_indices))
        trin_err, aux_trin_err = trainer.evaluate("train", next(trin_indices))
        print("{:5.2f}%  ({:5.2f}%)      {:5.2f}%  ({:5.2f}%)".format(
            trin_err, aux_trin_err, test_err, aux_test_err))
        log.checkpoint_flush()
        if saved_file_name:
            os.remove(saved_file_name)
        saved_file_name = pickle_file_name.format(test_err)
        trainer.save_checkpoint(saved_file_name)

    np.set_printoptions(precision=2)
    print("Training ...")
    print("Epoch   Cost  Tr_Error Tr_{0}    Te_Error Te_{0}".format(
        aux_err_name))
    n_train_imgs = trainer.n_train_batches * batch_sz
    epochs_to_test = tr_prms["EPOCHS_TO_TEST"]
    is_exp_head = layers[-1][0][:3] == "Exp"
    profile_dir = os.environ.get("THEANET_PROFILE_DIR")

    def diverged(min_true_f):
        return is_exp_head and float(min_true_f.min()) < -6

    def watchdogs(epoch, total_cost, costs, min_true_f):
        # reference train.py:214-226
        if diverged(min_true_f):
            ibatch = int(min_true_f.argmin())
            print("Epoch:{} Iteration:{}".format(epoch, ibatch))
            print("min true-class feature:", float(min_true_f.min()))
            trainer.sync_net()
            print(net.get_wts_info(detailed=True))
        if np.isnan(total_cost):
            ibatch = int(np.argmax(np.isnan(costs)))
            print("Epoch:{} Iteration:{}".format(epoch, ibatch))
            trainer.sync_net()
            print(net.get_wts_info(detailed=True))
            raise ZeroDivisionError(
                "Nan cost at Epoch:{} Iteration:{}".format(epoch, ibatch))

    epoch = 0
    while epoch < n_epochs:
        # a chunk ends at the next test boundary (epoch % EPOCHS_TO_TEST
        # == 0 tests, reference train.py:228) or at the final epoch
        if epoch % epochs_to_test == 0:
            chunk_end = epoch
        else:
            chunk_end = min((epoch // epochs_to_test + 1) * epochs_to_test,
                            n_epochs - 1)
        chunk_len = chunk_end - epoch + 1
        # epoch 0 holds the first calls' set-up: trace the round after it
        with (_profiled(device, trainer, profile_dir, out_file_head)
              if profile_dir and epoch == 1
              else contextlib.nullcontext()):
            t_epoch = time.time()
            test_row_epoch = net.get_epoch() + chunk_len - 1
            snap = trainer.snapshot_state()
            totals, costs2d, minf2d = trainer.run_epochs(chunk_len)
            dt = time.time() - t_epoch
            print("epoch{} {} took {:.2f}s ({:,.0f} images/sec)".format(
                "s" if chunk_len > 1 else "",
                "{}-{}".format(epoch, epoch + chunk_len - 1)
                if chunk_len > 1 else epoch, dt,
                n_train_imgs * chunk_len / dt), file=sys.stderr)
            replayed = False
            for j in range(chunk_len):
                if ((np.isnan(totals[j]) or diverged(minf2d[j]))
                        and j < chunk_len - 1):
                    # replay to the failing epoch for the at-failure dump
                    trainer.restore_state(snap)
                    trainer.run_epochs(j + 1)
                    replayed = True
                watchdogs(epoch + j, float(totals[j]), costs2d[j], minf2d[j])
            if replayed:
                # only the divergence dump returns here (a NaN raises): train
                # on from where the chunk had got
                trainer.restore_state(snap)
                trainer.run_epochs(chunk_len)
            total_cost = float(totals[-1])

            if (epoch + chunk_len - 1) % epochs_to_test == 0:
                print("{:3d} {:>8.2f}".format(test_row_epoch, total_cost),
                      end="    ")
                with tracing.span("cli.test_boundary"):
                    do_test()
                if total_cost > 1e6:
                    trainer.sync_net()
                    print(net.get_wts_info(detailed=True))
        epoch += chunk_len

    test_err, aux_test_err = trainer.evaluate_full("test")
    trin_err, aux_trin_err = trainer.evaluate_full("train")
    print("{:3d} {:>8.2f}".format(net.get_epoch(), 0), end="    ")
    print("{:5.2f}%  ({:5.2f}%)      {:5.2f}%  ({:5.2f}%)".format(
        trin_err, aux_trin_err, test_err, aux_test_err))
    return trainer


if __name__ == "__main__":
    main()

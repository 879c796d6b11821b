#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (theanet_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --phases 1,2   # a subset, for a quick build check

Phases (any failure exits non-zero; nothing is caught and skipped):

  1. the card: name and power limit, TF32 off, build the CUDA kernel from
     theanet_tpu_torch/csrc/megastep.cu and print its build time;
  2. one training step at full mnist_cnn shapes with its augmentation
     config, nearest and bilinear: kernel vs the plain PyTorch twin
     (cost, minf, all 8 params and 8 momenta after the step); then the
     kernel's other options (activation kinds, ignore_border pools, three
     input channels, 5x5 filters and 3x3 pools, L1/L2/max-norm) at small
     shapes, three steps each, step-locked;
  3. one full synth_hard epoch (600 steps): kernel vs twin, cost stream and
     final params;
  4. the main path: ``theanet_tpu_torch.train.main`` on synth_hard with
     params/mnist_cnn.prms (NUM_EPOCHS cut to 2, SEED pinned), then a
     resume of one epoch from the kept checkpoint; the kernel's launch
     counter must show that every epoch went through the kernel;
  5. time one epoch of the kernel and one of the twin.

The line before the last is the kernel JSON object and the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# phase 2: one step. f32 sums in another order than the twin's cuBLAS/cuDNN
# calls differ by a few ulps; the state after one step is within this.
STEP_ATOL = 1e-5
STEP_COST_ATOL = 1e-4
# phase 3, step-locked: every step of the epoch starts both from the
# kernel's state, so differences cannot compound. A step is held to
# STEP_ATOL unless its warp has a pixel within 1e-4 of a nearest-rounding
# boundary, where the two warps' last-ulp differences may move one pixel of
# every image to its neighbour; such a step must still agree within
# FLIP_ATOL (one pixel's worth of gradient).
FLIP_ATOL = 2e-3
# phase 3, free-running: SGD at lr .1 amplifies last-ulp differences (sum
# order in the dense products, the rare nearest flip) until the trajectories
# decorrelate at the noise level of training. Measured on the CPU for the
# same epoch, the JAX package's kernel and the twin (one function, two sum
# orders) differ by 0.08 in step cost and 0.10 in parameters, and their
# epoch totals by 0.2%. A wrong formula moves the epoch total by far more.
FREE_STEP_COST_ATOL = 0.3
FREE_PARAM_ATOL = 0.3
FREE_TOTAL_RTOL = 5e-3
# phase 4: the .prms leaves SEED unset (a fresh draw per run), and at some
# seeds the recipe sits at chance for the first epochs in the JAX package
# too (SEED 131492: epoch costs 1392.28, 1381.51, 1380.42, test error 88.55%
# after three epochs on the CPU). So the copy pins SEED to one of the
# seeds of PARITY_r05.md, where the JAX package reaches 22.60% test error
# after three epochs (CPU) and the TPU run 22.35% (parity_hard_r05.json).
# Chance on 10 classes is 90%; 40% allows the few-point transients that
# different random bits give mid-curve and fails a net that did not learn.
MAIN_SEED = 9876
MAIN_TEST_ERR_MAX = 40.0


def banner(n, title):
    print(f"\n=== phase {n}: {title}", flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def load_flagship(torch, nearest=None):
    """(net, spec) of params/mnist_cnn.prms at 28x28, one channel."""
    from theanet_tpu_torch.model import NeuralNet
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.prms import load_params

    layers, tr, _ = load_params(os.path.join(REPO, "params", "mnist_cnn.prms"))
    layers[0][1]["img_sz"] = 28
    tr["SEED"] = 1   # the .prms leaves SEED unset (a random draw)
    net = NeuralNet(layers, tr)
    spec = megastep.spec_from_net(net)
    assert spec is not None, megastep.fused_decline_reason(net)
    if nearest is not None:
        spec = spec._replace(nearest=nearest)
    return net, spec


def max_abs(a, b):
    return float((a - b).abs().max())


def near_rounding_pixels(torch, megastep, spec, bits, step):
    """Pixels of a step's warp whose t + .5 lies within 1e-4 of an integer:
    there an f32 rounding difference can flip the nearest-resample index."""
    gh, gw = megastep.smoothing_factors(spec, bits[0].device)
    ty, tx = megastep.warp_field(spec, bits[0][step, 0], bits[1][step], gh, gw)
    t = torch.cat([ty, tx]) + 0.5
    return int(((t - torch.round(t)).abs() < 1e-4).sum())


def phase2(torch, data, dev):
    from theanet_tpu_torch.model import params_from_allwts
    from theanet_tpu_torch.ops import megastep

    worst = 0.0
    for nearest in (True, False):
        net, spec = load_flagship(torch, nearest)
        kp = megastep.kernel_layout(params_from_allwts(
            [net.allwts0[i] for i in megastep.MEGA_LAYER_IDX], dev), spec)
        gen = torch.Generator(device=dev).manual_seed(11)
        km = [0.01 * torch.randn(t.shape, generator=gen, device=dev)
              for t in kp]  # nonzero: the step must move the parameters
        x, y = data
        # the first epoch index whose step-0 warp has no near-rounding
        # pixel, so one step is held to ulp-level agreement
        for epoch in range(50):
            bits = megastep.epoch_noise_bits(7, epoch, spec, 1, dev)
            if not spec.nearest or near_rounding_pixels(
                    torch, megastep, spec, bits, 0) == 0:
                break
        got = megastep.megastep_epoch(kp, km, x[:1], y[:1], bits, 0.1, spec)
        ref = megastep.megastep_epoch_reference(kp, km, x[:1], y[:1], bits,
                                                0.1, spec)
        torch.cuda.synchronize()
        d_cost = max_abs(got[2][:, 0], ref[2][:, 0])
        d_minf = max_abs(got[2][:, 1], ref[2][:, 1])
        d_p = max(max_abs(a, b) for a, b in zip(got[0], ref[0]))
        d_m = max(max_abs(a, b) for a, b in zip(got[1], ref[1]))
        moved = max(max_abs(a, b) for a, b in zip(got[0], kp))
        print("  per tensor |d| params", ["%.1e" % max_abs(a, b) for a, b in
                                         zip(got[0], ref[0])],
              "moms", ["%.1e" % max_abs(a, b) for a, b in zip(got[1], ref[1])])
        print(f"nearest={nearest} (noise epoch {epoch}): cost kernel "
              f"{float(got[2][0, 0]):.6f} twin {float(ref[2][0, 0]):.6f}; "
              f"max|d| cost {d_cost:.3e} minf {d_minf:.3e} params {d_p:.3e} "
              f"moms {d_m:.3e}; params moved {moved:.3e}", flush=True)
        assert math.isfinite(float(got[2][0, 0]))
        assert moved > 0, "the step did not move the parameters"
        assert d_cost <= STEP_COST_ATOL and d_minf <= STEP_COST_ATOL, \
            (d_cost, d_minf)
        assert d_p <= STEP_ATOL and d_m <= STEP_ATOL, (d_p, d_m)
        worst = max(worst, d_cost, d_minf, d_p, d_m)
    return worst


# The kernel's options beyond mnist_cnn's own config (whose regularizers are
# all zero): the variants tests/test_torch_megastep.py holds the twin to the
# JAX package's kernel with, at its small shapes, with L1, L2 and max-norm on.
VARIANT_REGS = [dict(L1=0.0, L2=1e-3, momentum=0.95, rate=1.0, maxnorm=0.9),
                dict(L1=0.0, L2=0.0, momentum=0.95, rate=1.0, maxnorm=0.0),
                dict(L1=1e-4, L2=0.0, momentum=0.9, rate=1.0, maxnorm=0.7),
                dict(L1=0.0, L2=0.0, momentum=0.95, rate=0.5, maxnorm=0.8)]
FULL_AUG = dict(translation=2, zoom=1.1, magnitude=8, sigma=3, pflip=0.03,
                angle=5, invert=True)
SPEC_VARIANTS = {
    "smooth-acts-bilinear": dict(act1="tanh", act2="sigmoid",
                                 act_h="scaled_tanh", pdrop=0.5, **FULL_AUG),
    "softplus-ignore-border": dict(img=13, act_h="softplus", ib1=True,
                                   ib2=True, nearest=True, **FULL_AUG),
    "3-channel-nearest": dict(img=10, in_ch=3, nearest=True, pdrop=0.5,
                              **FULL_AUG),
    "filt5-pool3": dict(img=15, filt1=5, pool1=3, maps1=3, maps2=5),
}


def variant_spec(megastep, kw):
    base = dict(batch=4, img=12, filt1=3, filt2=3, maps1=2, maps2=3,
                n_hid=16, n_out=4, slope1=0.05, slope2=0.10, slope_h=0.01,
                pdrop=0.0, translation=0, zoom=1, magnitude=0, sigma=1,
                pflip=0.0, angle=0, invert=False, nearest=False)
    base.update(kw)
    r1, r2, rh, ro = (megastep.LayerReg(**r) for r in VARIANT_REGS)
    return megastep.MegaSpec(reg1=r1, reg2=r2, reg_h=rh, reg_o=ro, **base)


def step_locked(torch, megastep, spec, p, m, x, y, bits):
    """Each step of both versions from the kernel's state: (worst |d| on
    steps without a near-rounding pixel, worst on steps with one, number of
    such steps, final kernel state)."""
    worst_clean = worst_flip = 0.0
    n_near = 0
    for s in range(x.shape[0]):
        sl = slice(s, s + 1)
        b_s = tuple(b[sl] for b in bits)
        got = megastep.megastep_epoch(p, m, x[sl], y[sl], b_s, 0.1, spec)
        ref = megastep.megastep_epoch_reference(p, m, x[sl], y[sl], b_s, 0.1,
                                                spec)
        assert bool(torch.isfinite(got[2]).all())
        d = max([max_abs(got[2], ref[2])]
                + [max_abs(a, b) for a, b in zip(got[0] + got[1],
                                                 ref[0] + ref[1])])
        if spec.nearest and near_rounding_pixels(torch, megastep, spec, b_s,
                                                 0):
            n_near += 1
            worst_flip = max(worst_flip, d)
        else:
            worst_clean = max(worst_clean, d)
        p, m = got[0], got[1]
    return worst_clean, worst_flip, n_near, (p, m)


def phase2_variants(torch, dev):
    from theanet_tpu_torch.ops import megastep

    worst = 0.0
    for name, kw in SPEC_VARIANTS.items():
        spec = variant_spec(megastep, kw)
        gen = torch.Generator(device=dev).manual_seed(5)
        shapes = megastep.kernel_shapes(spec)
        p = [0.3 * torch.randn(s, generator=gen, device=dev) for s in shapes]
        m = [0.01 * torch.randn(s, generator=gen, device=dev) for s in shapes]
        nb = 3
        x = torch.rand((nb, spec.in_ch * spec.batch, spec.hw), generator=gen,
                       device=dev)
        y = torch.randint(0, spec.n_out, (nb, spec.batch), generator=gen,
                          device=dev, dtype=torch.int32)
        bits = megastep.epoch_noise_bits(9, 0, spec, nb, dev)
        clean, flip, n_near, (p1, _) = step_locked(torch, megastep, spec, p,
                                                   m, x, y, bits)
        moved = max(max_abs(a, b) for a, b in zip(p1, p))
        print(f"  {name}: {nb} steps step-locked, max|d| {clean:.3e} "
              f"({n_near} steps with a near-rounding pixel: {flip:.3e}); "
              f"params moved {moved:.3e}", flush=True)
        assert moved > 0, "the steps did not move the parameters"
        assert clean <= STEP_ATOL and flip <= FLIP_ATOL, (clean, flip)
        worst = max(worst, clean)
    return worst


def epoch_inputs(torch, megastep, spec, data, dev):
    from theanet_tpu_torch.model import params_from_allwts

    net, _ = load_flagship(torch)
    kp = megastep.kernel_layout(params_from_allwts(
        [net.allwts0[i] for i in megastep.MEGA_LAYER_IDX], dev), spec)
    km = [torch.zeros_like(t) for t in kp]
    x, y = data
    bits = megastep.epoch_noise_bits(3, 0, spec, x.shape[0], dev)
    return kp, km, x, y, bits


def phase3(torch, data, dev):
    from theanet_tpu_torch.ops import megastep

    _, spec = load_flagship(torch)
    kp, km, x, y, bits = epoch_inputs(torch, megastep, spec, data, dev)
    nb = x.shape[0]

    worst_clean, worst_flip, n_near, _ = step_locked(torch, megastep, spec,
                                                     kp, km, x, y, bits)
    print(f"step-locked, {nb} steps: max|d| {worst_clean:.3e} on the "
          f"{nb - n_near} steps without a near-rounding pixel, "
          f"{worst_flip:.3e} on the {n_near} with one", flush=True)
    assert worst_clean <= STEP_ATOL and worst_flip <= FLIP_ATOL, \
        (worst_clean, worst_flip)

    # free-running
    got = megastep.megastep_epoch(kp, km, x, y, bits, 0.1, spec)
    ref = megastep.megastep_epoch_reference(kp, km, x, y, bits, 0.1, spec)
    torch.cuda.synchronize()
    d_cost = max_abs(got[2][:, 0], ref[2][:, 0])
    d_p = max(max_abs(a, b) for a, b in zip(got[0], ref[0]))
    tot_k, tot_t = float(got[2][:, 0].sum()), float(ref[2][:, 0].sum())
    print(f"free-running: epoch cost kernel {tot_k:.4f} twin {tot_t:.4f}; "
          f"max|d| step cost {d_cost:.3e} (mean "
          f"{float((got[2][:, 0] - ref[2][:, 0]).abs().mean()):.3e}), final "
          f"params {d_p:.3e}", flush=True)
    assert bool(torch.isfinite(got[2]).all())
    assert d_cost <= FREE_STEP_COST_ATOL and d_p <= FREE_PARAM_ATOL, \
        (d_cost, d_p)
    assert abs(tot_k - tot_t) <= FREE_TOTAL_RTOL * abs(tot_t), (tot_k, tot_t)
    return max(worst_clean, worst_flip)


def run_cli(train_mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_mod.main(argv)
    out = buf.getvalue()
    print(out, flush=True)
    return out


def phase4(torch):
    from theanet_tpu_torch import train
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.prms import load_params

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            with open(os.path.join(REPO, "params", "mnist_cnn.prms")) as f:
                text = f.read()
            assert "'NUM_EPOCHS':          101," in text
            with open("mnist_cnn.prms", "w") as f:
                f.write(text.replace(
                    "'NUM_EPOCHS':          101,",
                    f"'NUM_EPOCHS':          2, 'SEED': {MAIN_SEED},"))
            megastep.megastep_epoch.launches = 0
            fresh = run_cli(train, ["train", "synth_hard", "mnist_cnn.prms"])
            pkls = [p for p in os.listdir(".") if p.endswith(".pkl")]
            assert len(pkls) == 1, pkls
            # NUM_EPOCHS counts the epochs a run trains: resume for one more
            layers, tr, allwts = load_params(pkls[0])
            tr["NUM_EPOCHS"] = 1
            with open("resume.pkl", "wb") as f:
                pickle.dump({"layers": layers, "training_params": tr,
                             "allwts": allwts}, f, -1)
            resumed = run_cli(train, ["train", "synth_hard", "resume.pkl"])
            launches = megastep.megastep_epoch.launches
        finally:
            os.chdir(cwd)
    for out in (fresh, resumed):
        assert "Epoch   Cost  Tr_Error Tr_P(MLE)    Te_Error Te_P(MLE)" in out
        assert "Device : cuda" in out
    assert "\n  2 " in resumed, "the resume did not continue at epoch 2"
    final = resumed.strip().splitlines()[-1].split()
    test_err = float(final[-2].rstrip("%"))
    print(f"kernel launches in the main path: {launches} (3 epochs); final "
          f"test error {test_err:.2f}% (bound {MAIN_TEST_ERR_MAX}%, chance "
          "90%)", flush=True)
    assert launches == 3, launches
    assert test_err < MAIN_TEST_ERR_MAX, test_err
    return launches


def phase5(torch, data, dev, card):
    from theanet_tpu_torch.ops import megastep

    _, spec = load_flagship(torch)
    kp, km, x, y, bits = epoch_inputs(torch, megastep, spec, data, dev)
    n_img = x.shape[0] * spec.batch

    def timed(fn, reps):
        fn()   # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    saved = megastep.megastep_epoch.launches
    ms_k1 = timed(lambda: megastep.megastep_epoch(kp, km, x, y, bits, 0.1,
                                                  spec), 3)
    ms_t = timed(lambda: megastep.megastep_epoch_reference(
        kp, km, x, y, bits, 0.1, spec), 1)
    ms_k2 = timed(lambda: megastep.megastep_epoch(kp, km, x, y, bits, 0.1,
                                                  spec), 3)
    megastep.megastep_epoch.launches = saved  # timing launches do not count
    ms_k = min(ms_k1, ms_k2)
    print(f"one mnist_cnn epoch ({x.shape[0]} steps x {spec.batch}) on {card}:"
          f" kernel {ms_k1:.3f} / {ms_k2:.3f} ms ({n_img / ms_k * 1e3:,.0f} "
          f"images/s), twin {ms_t:.3f} ms ({n_img / ms_t * 1e3:,.0f} "
          "images/s)", flush=True)
    return ms_k, ms_t


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "theanet_tpu_torch")):
        print("chip_smoke: run it from a checkout (theanet_tpu_torch/ is "
              "missing next to this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.environ["THEANET_TORCH_DEVICE"] = "cuda"
    dev = torch.device("cuda")

    banner(1, "card and kernel build")
    card = nvidia_smi()
    print(card, flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0], flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from theanet_tpu_torch.ops import _build

    t0 = time.time()
    _build.build(verbose=True)
    print(f"built csrc/megastep.cu in {time.time() - t0:.1f} s", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  ptxas:", line.strip())

    from theanet_tpu_torch.data import synth_hard

    nb = synth_hard.training_x.shape[0] // 20
    data = (torch.as_tensor(synth_hard.training_x[:nb * 20], device=dev)
            .reshape(nb, 20, 784),
            torch.as_tensor(synth_hard.training_y[:nb * 20], device=dev)
            .reshape(nb, 20))
    step_err = epoch_err = launches = ms_k = ms_t = None
    if 2 in phases:
        banner(2, "one step, kernel vs twin (nearest and bilinear; the "
               "kernel's other options at small shapes)")
        step_err = max(phase2(torch, data, dev),
                       phase2_variants(torch, dev))
    if 3 in phases:
        banner(3, "one epoch, kernel vs twin")
        epoch_err = phase3(torch, data, dev)
    if 4 in phases:
        banner(4, "main path: train.main on synth_hard + resume")
        launches = phase4(torch)
    if 5 in phases:
        banner(5, "epoch time, kernel vs twin")
        ms_k, ms_t = phase5(torch, data, dev, card)
    if phases != {1, 2, 3, 4, 5}:
        print("chip_smoke: a subset of phases ran; no result", flush=True)
        return 3

    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"kernels": [{
        "name": "megastep_epoch", "route": "cuda",
        "source": "theanet_tpu_torch/csrc/megastep.cu",
        "replaces": "theanet_tpu/ops/megastep.py:2162",
        "launches": launches, "max_abs_err": step_err,
        "epoch_step_locked_max_abs_err": epoch_err,
        "ms": ms_k, "plain_ms": ms_t}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

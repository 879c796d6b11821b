#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (theanet_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --phases 1,2   # a subset, for a quick build check

Phases (any failure exits non-zero; nothing is caught and skipped):

  1. the card: name and power limit, TF32 off, build every CUDA library of
     theanet_tpu_torch/csrc (one nvcc per source, run together) and print
     the build time;
  2. one training step at full mnist_cnn shapes with its augmentation
     config, nearest and bilinear: kernel vs the plain PyTorch twin
     (cost, minf, all 8 params and 8 momenta after the step); then the
     kernel's other options (activation kinds, ignore_border pools, three
     input channels, 5x5 filters and 3x3 pools, L1/L2/max-norm) at small
     shapes, three steps each, step-locked; the head's stages of the
     full-shape step by torch.profiler beside the head's bound; a label
     outside the classes and a dropped unit with an inf pre-activation give
     a NaN cost;
  3. one full synth_hard epoch (600 steps): kernel vs twin, cost stream and
     final params; the free-running epoch times and the head's stages;
  4. the main path: ``theanet_tpu_torch.train.main`` on synth_hard with
     params/mnist_cnn.prms (NUM_EPOCHS cut to 2, SEED pinned), then a
     resume of one epoch from the kept checkpoint; the kernel's launch
     counter must show that every epoch went through the kernel;
  5. time one epoch of the kernel and one of the twin; its stages and its
     head's stages (torch.profiler) beside the head's bound;
  6. the deep kernel (csrc/megastep_deep.cu) vs its twin: one step, then
     every step of a step-locked epoch, for galaxy_rbf on synth3 and
     logit_centered and synth_quick on synth at their shipped widths; then
     small variants (three conv levels with an identity and an
     ignore_border pool, a pre-hidden stack with DropOut, a flat net with a
     Color prefix and two hiddens, three levels the first wider than a
     warp, RBF with frozen centers and junk_dist inf) with L1, L2 and
     max-norm on; a label outside the classes gives a NaN cost;
  7. the flat-MLP kernel (the deep library at a zero-level table) vs its
     twin: flat_mlp at full width on synth_hard, one step and a
     step-locked epoch;
  8. the main path of both families: ``train.main`` for galaxy_rbf (all 10
     epochs, SEED pinned, then a 1-epoch resume), logit_centered,
     synth_quick and flat_mlp (2 epochs), then galaxy_rbf for 3 epochs at
     five SEEDs; each family's launch counter must show one launch per
     epoch, and each run's test rows are printed beside, and held to, the
     JAX package's CPU run of the same configuration
     (jax_cpu_reference.sh);
  9. time one epoch of each of phase 8's configurations, kernel and twin,
     at full width, and print each kernel's device time by stage and its
     head's stages beside the head's bound (torch.profiler); then, at
     mnist_cnn, galaxy_rbf and flat_mlp, the three stage kinds of
     csrc/stages.cuh (conv weight gradient, conv input gradient, dense
     products) in us/step beside their bound and one PyTorch call of the
     same work (a yardstick, TF32 off); and every launch plan of
     ops/stage_plan.py held to the C's (stage_*_plan) and the mirrored
     workspace to *_workspace_floats, over PLAN_CONFIGS;
 10. the elastic resample kernel (csrc/elastic_resample.cu) vs its plain
     version on the same warp and flip words: mnist_cnn's batch (nearest,
     invert, pflip .03), a 3-channel bilinear batch and a 48x48 one; its
     time per launch beside the plain version's and F.grid_sample's;
 11. the FUSED_TAIL kernels (csrc/fused_mlp.cu) vs their plain versions:
     forward and backward at mnist_cnn's tail, slopes .01, 0 and 1, pdrop
     .5 in train and eval mode, and the 10000-row eval window; their times
     per launch;
 12. the per-layer path: ``train.main`` on synth_hard with mnist_cnn.prms
     plus FUSED_TAIL and the ElasticLayer's 'method': 'pallas' (2 epochs,
     SEED pinned, then a 1-epoch resume); the counters must show one
     elastic, one tail-forward and one tail-backward launch per training
     step, one tail forward per eval window and no fused epoch; the final
     test error is held to the JAX package's CPU run of the same .prms;
     then one per-layer epoch timed with FUSED_TAIL and 'pallas', and with
     neither;
 13. the 3x3 conv kernel (csrc/conv3x3.cu: forward, dx, dw on the tensor
     cores, bf16 MMA and 3xTF32) vs its plain version in f32 and bf16 at
     bench.py's wide conv2, the shapes of tests/test_conv_pallas.py and
     four ragged shapes; the backward twice, bit-equal; at the wide shape
     the kernel's time with its achieved TFLOP/s and share of the bound
     beside the plain version's and cuDNN's, and each stage's device time
     (torch.profiler: the layout passes, the weight tables, the forward,
     dx, dw and the slice sum);
 14. bench.py's wide model (56x56, conv 64 -> conv 128, hidden 2048,
     softmax 1000, batch 256, bf16, its data) through NeuralNet and
     Trainer with THEANET_PALLAS_CONV=1 and MEGAFUSED 'auto': the Trainer
     must name the route rule as its decline (the JAX package's byte
     models decline it, and its head does not fit shared memory); the
     initial eval
     NLL is held to the JAX package's CPU forward; 2 epochs of 80 steps and
     the second again from snapshot_state, one conv forward and backward
     launch per step and one forward per eval batch, the replay bit-equal;
     5 steps step-locked against the plain conv (cost and conv2's new
     momentum); epoch times with the kernel and with cuDNN;
 15. the data-parallel step's kernels (csrc/megastep.cu and
     csrc/megastep_deep.cu: ``*_grad_step`` and ``*_update``) vs their
     plain versions at full width: mnist_cnn at 20 and 10 samples a rank,
     galaxy_rbf and flat_mlp (a zero-level deep spec) at 10; their times a
     call; then one step-locked epoch of mnist_cnn and galaxy_rbf through
     the world-1 DP step (NCCL, this process), the epoch kernel and the
     twin, and two emulated ranks against the epoch kernel;
 16. the data-parallel main path, ``Trainer(mesh=make_mesh())``: mnist_cnn
     at world 1 on NCCL, then mnist_cnn, galaxy_rbf and flat_mlp at world 2
     on gloo (two processes sharing the card, started by
     ``parallel.launch``), 2 epochs each, against the single-device fused
     Trainer's costs; one gradient and one update launch a step a rank, the
     ranks' parameters bit-identical, rank 0 alone checkpointing; epoch
     times and the device's idle share (THEANET_DP_RING=0: the per-step
     path);
 17. the ring's exchange kernel (csrc/ring.cuh) vs exchange_reference over
     n buffers of this process, at mnist_cnn's and galaxy_rbf's state:
     gather at 2 ranks, reduce-scatter at 2 (THEANET_RING_RS=1), 3 and 4,
     both slot parities, bit for bit; its time a call beside the plain
     version's and dist.all_reduce's (world 1, NCCL); the ring epoch
     entries (megastep_ring_epoch at mnist_cnn in both modes,
     deep_ring_epoch at galaxy_rbf) at 2 ranks in this process, one thread
     and stream a rank, one step a call, step-locked against
     ring_epoch_reference's plain version; then mnist_cnn at BATCH_SZ 600
     and 1024 (beyond 48 KB of the former one-block head's scratch): it
     fuses,
     and the flagship kernel follows its twin step-locked;
 18. the ring main path, ``Trainer(mesh=make_mesh())`` under
     THEANET_DP_RING: at world 1 in this process (NCCL) mnist_cnn and
     galaxy_rbf take the ring under 'auto' and equal the single-device
     epoch kernel to the bit; at world 2 (gloo, two processes on the card
     mapping each other's buffers through CUDA IPC) mnist_cnn, galaxy_rbf
     and flat_mlp in gather mode and mnist_cnn in reduce-scatter mode, and
     at world 4 mnist_cnn at 5 a rank (reduce-scatter), each rank
     bit-equal to the others and to ring_epoch_reference's emulation on
     the card, epoch totals within 5% of the single device's; one ring
     epoch launch an epoch a rank and the exchange kernels its C loop
     counts (2 a step in gather mode, 4 in reduce-scatter); epoch times
     and idle share per rank.
 19. the deep kernel's heads and aux stages (csrc/megastep_deep.cu) vs its
     twin, step-locked from the initial weights and random momenta: synth_aux
     at full width (B 20, 28x28, conv 4@3x3, SoftAux 10 classes, n_aux
     (5, 9)) over its whole epoch, galaxy_rbf's shapes under a Hinge, an
     ExpLoss, an nllsq, an nll90 and an AuxConcat -> Softmax tail, and a
     flat Hinge net, 40 steps each; each state tensor within 1e-5 of the
     larger of 1 and its largest value;
 20. the synth_aux main path: ``train.main`` on params/synth_aux.prms as
     shipped (3 epochs, SEED 2718), fused (one deep kernel launch an epoch)
     then a 1-epoch resume, and per layer (MEGAFUSED False, no kernel);
     final test errors within 2 (fused) and 3 (per layer) points of the
     JAX package's CPU run; one epoch of each timed by CUDA events beside
     the twin's; a world-2 ring run (two processes on the card), ranks
     bit-equal to each other and to the in-process emulation.
 21. the deep kernel's conv geometry vs its twin, step-locked from the
     initial weights and random momenta (each state tensor within 1e-5 of
     max(1, its largest value); a step whose nearest warp has a
     near-rounding pixel, as in phase 3, or whose twin has a hidden
     pre-activation within KINK_ATOL of 0, within FLIP_ATOL): mnist_cnn's
     layers and widths with both convs 'same' (mnist_same), the same with
     a MeanLayer (mnist_same_mean), conv1 at stride 2 (mnist_stride), conv1
     'full' with its pool at 4 (mnist_full), each over a 600-step epoch of
     synth_hard; the geometries of tests/test_fused_modes.py, an even
     'same' filter, a MeanLayer after a valid stack and the gradient
     stages' wide forms, 40 steps each (the wide ones 3-4); then
     deep_grad_step at 10 a rank and deep_ring_epoch at two emulated ranks
     on mnist_same against their plain versions;
 22. the geometry main path: ``train.main`` on synth_hard with mnist_same
     as a .prms (3 epochs, SEED 9876, then a 1-epoch resume), one deep
     kernel launch an epoch and no other kernel launch, the final test
     error at most 2 points above the JAX package's CPU run; one epoch of
     each geometry configuration timed by CUDA events beside the twin's,
     with its bound and its stages; mnist_same at world 2 on the ring
     (two processes on the card), bit-equal to its emulation.
 23. the heads and batches beyond the route rule's head threshold, which
     its JAX clause takes: mnist_cnn's layers
     at BATCH_SZ 3000, at B 128 with 457 classes and at B 20 with 1453
     classes, flat_mlp's at B 128 with 457 classes, a three-level conv net
     at B 20 with 1500 classes, on synth_hard: each kernel against its
     twin, one step and HEAD_LOCKED_STEPS steps step-locked (each state
     tensor within 1e-5 of max(1, its largest value)); a timed epoch of
     each, launches counted, with its head's stages, their share of the
     busy time and the head's bound; megastep_grad_step and deep_grad_step against
     their plain versions; train.main with mnist_cnn.prms at BATCH_SZ 3000
     and MEGAFUSED True (3 epochs and a 1-epoch resume, one launch an
     epoch), its test rows against the JAX package's CPU run; the fused
     Trainer's epochs beside the per-layer one's, alternated, at BATCH_SZ
     256 to 3000 (the JAX Trainer's 'auto' crossover, ROADMAP fault 3);
 24. the probe kernels of csrc/probes.cu (floor, conv section, relay)
     against their plain versions in every variant and launch mode; their
     epoch times beside the plain versions and the bounds; then the probe
     tools (python -m theanet_tpu_torch.tools.floor_probe,
     .conv_layout_probe) on the card, us/step for every variant at one
     launch an epoch and one a step, beside the card's name and power
     limit.
 25. one column of Ciresan et al.'s multi-column DNN for GTSRB
     (params/gtsrb_mcdnn.prms: 3x48x48-100C7-MP2-150C4-MP2-250C4-MP2-
     300N-43N, BATCH_SZ 20) at its published widths on signs48: the route
     (the deep family, no decline, no stage limit), the two input-
     gradient paths at the column's levels 2 and 3 on the same dz and
     weights (k_conv_dgrad_tiled's din equal to k_conv_dgrad's, bit for
     bit; each timed beside the bound), the deep kernel
     against its twin step-locked over GTSRB_LOCKED_STEPS steps from the
     initial weights and random momenta (phase 19's rule: each state
     tensor within 1e-5 of max(1, its largest value)); an epoch of kernel
     and twin timed, its stages profiled, the tiled launches counted (2 a
     step), the three stage kinds in us/step beside their bounds;
     ``train.main`` on signs48 with
     the .prms (GTSRB_EPOCHS epochs, SEED pinned), one deep kernel launch
     an epoch and no other, the loss falling.
 26. (with ``--parent DIR``, an unpacked archive of the parent commit)
     the flagship library against the parent's, built from DIR's
     csrc/megastep.cu: from the same state, momenta and noise words, one
     mnist_cnn epoch of synth_hard at BATCH_SZ 20 and at 256, phase 23's
     flagship heads and batches and phase 2's 3-channel-nearest and
     smooth-acts-bilinear variants, every state tensor and cost row equal
     (torch.equal); where a bilinear warp's bits differ, each library's
     augmented image against the twin's ``augment``, this checkout's
     equal to it.

Without ``--parent`` phases 1-25 run; with it, phase 26 too.
The last three lines are the kernels JSON object, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. The script imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import pickle
import re
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
ALL_PHASES = tuple(range(1, 26))
PARENT_PHASE = 26


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
        if nearest:
            profile_epoch(torch, lambda: megastep.megastep_epoch(
                kp, km, x[:1], y[:1], bits, 0.1, spec), 1, "one step",
                top=0, head=("mnist_cnn, one step", spec))
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


def kink_flips(torch, megastep, spec, params, x, bits_s):
    """The flagship twin's step resolved at the leaky kink: for a step whose
    kept hidden units have pre-activations within KINK_ATOL of 0 (at most
    KINK_UNITS of them), each nonempty subset of those units as a (1, B, NH)
    bool mask for megastep_epoch_reference's ``flips`` (their derivative
    on the other side of 0, where the kernel's sum order may put them);
    else no mask."""
    if not isinstance(spec, megastep.MegaSpec) or spec.act_h != "leaky":
        return []
    gh, gw = megastep.smoothing_factors(spec, x.device)
    z3 = megastep.forward_to_hidden(spec, x, bits_s[0][0, 0], bits_s[1][0],
                                    bits_s[2][0], params, gh, gw)[-1]
    near = z3.abs() < KINK_ATOL
    if spec.pdrop:
        near &= megastep._u01(bits_s[3][0]) >= spec.pdrop
    units = near.nonzero().tolist()
    if not units or len(units) > KINK_UNITS:
        return []
    masks = []
    for pick in range(1, 1 << len(units)):
        mask = torch.zeros_like(near)
        for i, (b, j) in enumerate(units):
            mask[b, j] = bool(pick >> i & 1)
        masks.append(mask[None])
    return masks


def step_locked(torch, megastep, spec, p, m, x, y, bits, fns=None,
                cost_atol=None):
    """Each step of both versions from the kernel's state: (worst |d| on
    steps without a near-rounding pixel, worst on steps with one, number of
    such steps, final kernel state). ``fns`` is the (kernel wrapper, twin)
    pair, the flagship's by default. The worst |d| covers the state tensors
    and, unless ``cost_atol`` is given (then each step's cost and minf are
    held to it here), the cost and minf too. A flagship step beyond
    STEP_ATOL with hidden pre-activations within KINK_ATOL of 0 is compared
    with the twin run with each resolution of those units' leaky
    derivative (kink_flips) as well, and the closest counts, still held to
    STEP_ATOL: the tiled and the library GEMM may round such a
    pre-activation to either side of 0."""
    kernel, twin = fns or (megastep.megastep_epoch,
                           megastep.megastep_epoch_reference)
    worst_clean = worst_flip = 0.0
    n_near = 0

    def diff(ref):
        d = max(max_abs(a, b) for a, b in zip(got[0] + got[1],
                                              ref[0] + ref[1]))
        return d, max_abs(got[2], ref[2])

    for s in range(x.shape[0]):
        sl = slice(s, s + 1)
        b_s = tuple(b[sl] for b in bits)
        got = kernel(p, m, x[sl], y[sl], b_s, 0.1, spec)
        ref = twin(p, m, x[sl], y[sl], b_s, 0.1, spec)
        assert bool(torch.isfinite(got[2]).all())
        d, d_cost = diff(ref)
        if spec.nearest and near_rounding_pixels(torch, megastep, spec, b_s,
                                                 0):
            n_near += 1
            worst_flip = max(worst_flip, d, d_cost)
            p, m = got[0], got[1]
            continue
        if d > STEP_ATOL and twin is megastep.megastep_epoch_reference:
            d_run, flips = d, kink_flips(torch, megastep, spec, p, x[s], b_s)
            for mask in flips:
                d_f, d_cost_f = diff(twin(p, m, x[sl], y[sl], b_s, 0.1, spec,
                                          flips=mask))
                if d_f < d:
                    d, d_cost = d_f, d_cost_f
            if flips:
                print(f"    step {s}: hidden pre-activations within "
                      f"{KINK_ATOL:g} of 0; max|d| {d_run:.3e} against the "
                      f"twin, {d:.3e} against the closest of its "
                      f"{len(flips)} resolutions at the kink", flush=True)
        if cost_atol is None:
            worst_clean = max(worst_clean, d, d_cost)
        else:
            assert d_cost <= cost_atol, (s, got[2], ref[2])
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


def nan_edges(torch, dev):
    """The flagship kernel's NaN cases at a small spec (pdrop .5): a label
    outside [0, NC) gives a NaN cost (the twin refuses such a label), and a
    hidden bias of inf (a pre-activation of inf in every sample, 0 * inf
    where dropped) gives a NaN cost in the kernel and the twin."""
    from theanet_tpu_torch.ops import megastep

    spec = variant_spec(megastep, dict(pdrop=0.5))
    gen = torch.Generator(device=dev).manual_seed(3)
    p = [0.3 * torch.randn(s, generator=gen, device=dev)
         for s in megastep.kernel_shapes(spec)]
    m = [torch.zeros_like(t) for t in p]
    x = torch.rand((1, spec.batch, spec.hw), generator=gen, device=dev)
    y = torch.randint(0, spec.n_out, (1, spec.batch), generator=gen,
                      device=dev, dtype=torch.int32)
    bits = megastep.epoch_noise_bits(9, 0, spec, 1, dev)
    y_bad = y.clone()
    y_bad[0, 2] = spec.n_out
    c_label = float(megastep.megastep_epoch(p, m, x, y_bad, bits, 0.1,
                                            spec)[2][0, 0])
    p_inf = [t.clone() for t in p]
    p_inf[5][0, 3] = math.inf   # the hidden bias (kernel layout (1, NH))
    c_inf = [float(fn(p_inf, m, x, y, bits, 0.1, spec)[2][0, 0])
             for fn in (megastep.megastep_epoch,
                        megastep.megastep_epoch_reference)]
    print(f"  NaN cases: a label outside the classes, kernel cost {c_label};"
          f" an inf hidden pre-activation, kernel {c_inf[0]}, twin "
          f"{c_inf[1]}", flush=True)
    assert math.isnan(c_label) and all(map(math.isnan, c_inf)), (c_label,
                                                                  c_inf)


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

    # free-running, each epoch timed once by CUDA events
    out = {}
    ms_k = timed_once(torch, lambda: out.update(k=megastep.megastep_epoch(
        kp, km, x, y, bits, 0.1, spec)))
    ms_t = timed_once(torch, lambda: out.update(
        t=megastep.megastep_epoch_reference(kp, km, x, y, bits, 0.1, spec)))
    got, ref = out["k"], out["t"]
    print(f"free-running epoch: kernel {ms_k:.3f} ms (first call), twin "
          f"{ms_t:.3f} ms", flush=True)
    profile_epoch(torch, lambda: megastep.megastep_epoch(
        kp, km, x, y, bits, 0.1, spec), nb, top=0,
        head=("mnist_cnn, phase 3", spec))
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
    """Run the CLI; print its device line and epoch table (the banner and
    the layer and weight dumps stay out of the log) and return its whole
    output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_mod.main(argv)
    out = buf.getvalue()
    print("  $ " + " ".join(argv[1:]))
    for line in out.splitlines():
        if line.startswith(("Device :", "Epoch ")) or ROW.match(line):
            print("   ", line)
    sys.stdout.flush()
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

    saved = megastep.megastep_epoch.launches
    ms_k1 = timed(torch, lambda: megastep.megastep_epoch(
        kp, km, x, y, bits, 0.1, spec), 3)
    ms_t = timed(torch, lambda: megastep.megastep_epoch_reference(
        kp, km, x, y, bits, 0.1, spec), 1)
    ms_k2 = timed(torch, lambda: megastep.megastep_epoch(
        kp, km, x, y, bits, 0.1, spec), 3)
    megastep.megastep_epoch.launches = saved  # timing launches do not count
    ms_k = min(ms_k1, ms_k2)
    print(f"one mnist_cnn epoch ({x.shape[0]} steps x {spec.batch}) on {card}:"
          f" kernel {ms_k1:.3f} / {ms_k2:.3f} ms ({n_img / ms_k * 1e3:,.0f} "
          f"images/s), twin {ms_t:.3f} ms ({n_img / ms_t * 1e3:,.0f} "
          "images/s)", flush=True)
    bound = epoch_bound(spec, [x, y, *bits, *kp, *km],
                        [*kp, *km, torch.empty((x.shape[0], 2))], x.shape[0])
    profile_epoch(torch, lambda: megastep.megastep_epoch(
        kp, km, x, y, bits, 0.1, spec), x.shape[0], head=("mnist_cnn", spec))
    megastep.megastep_epoch.launches = saved
    return ms_k, ms_t, bound


# ------------------------------------------------------------ phases 6-9

# The configurations of the deep and flat-MLP families: their dataset, the
# SEED and epochs the main path runs (the .prms's own where it sets them;
# galaxy_rbf and flat_mlp leave SEED unset, and flat_mlp's 201 epochs are cut
# to 2), and the JAX package's CPU run of the same configuration
# (jax_cpu_reference.sh, which writes its .prms with config_text): the cost
# on each test row and the final test error, in percent.
CONFIGS = {
    "galaxy_rbf": dict(data="synth3", seed=1357, epochs=10,
                       jax_costs=(603.71, 140.27, 83.99, 62.39, 46.05),
                       jax_test_err=0.00),
    "logit_centered": dict(data="synth", seed=424242, epochs=4,
                           jax_costs=(5186.90, 1332.03, 1027.87, 834.86),
                           jax_test_err=0.00),
    "synth_quick": dict(data="synth", seed=314159, epochs=3,
                        jax_costs=(426.17, 96.61, 65.20), jax_test_err=0.00),
    "flat_mlp": dict(data="synth_hard", seed=2468, epochs=2,
                     jax_costs=(1670.83, 1536.95), jax_test_err=80.10),
}
# Bounds against those runs: galaxy_rbf, logit_centered and synth_quick end
# at most 2 points of test error above them. flat_mlp (near chance after 2
# epochs in both) is printed beside its run.
ERR_MARGIN = 2.0
# A test row's cost at one SEED hangs on the noise stream, and the port's
# (a torch.Generator) is not the JAX package's: the two share a run's
# initial weights but none of its augmentation and dropout draws. Across
# the SEEDs of GALAXY_SWEEP the JAX package's own epoch-2 cost spans 48.82
# to 140.27 (jax_cpu_reference.sh). So galaxy_rbf's costs are held to 10%
# of the JAX runs' as a mean over those SEEDs, 3 epochs each; each row of
# the pinned 10-epoch run is held to 35%, which catches a net that trains
# wrong but not the spread of one noise stream.
GALAXY_SWEEP = (1357, 11, 22, 33, 44)
GALAXY_SWEEP_EPOCHS = 3
# the JAX package's CPU runs of the sweep (jax_cpu_reference.sh): the costs
# of the epoch-0 and epoch-2 test rows at each SEED
GALAXY_SWEEP_JAX = {1357: (603.71, 140.27), 11: (604.71, 118.34),
                    22: (460.79, 48.82), 33: (496.27, 74.54),
                    44: (589.40, 123.69)}
SWEEP_COST_RTOL = 0.10
SEED_COST_RTOL = 0.35
# the card's published peaks (NVIDIA's H100 SXM data sheet, at 700 W): HBM
# bytes/s, f32 operations/s outside the tensor cores and dense bf16 on them
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12


def config_text(name, seed=None, epochs=None):
    """params/<name>.prms with SEED and NUM_EPOCHS set: those of CONFIGS,
    or the ones given."""
    cfg = CONFIGS[name]
    seed = cfg["seed"] if seed is None else seed
    epochs = cfg["epochs"] if epochs is None else epochs
    with open(os.path.join(REPO, "params", name + ".prms")) as f:
        text = f.read()
    text, n = re.subn(r"'SEED':\s*\d+,", f"'SEED': {seed},", text)
    if not n:
        old = "'BATCH_SZ':            20,"
        assert old in text, name
        text = text.replace(old, f"{old} 'SEED': {seed},")
    text, n = re.subn(r"'NUM_EPOCHS':(\s*)\d+,",
                      rf"'NUM_EPOCHS':\g<1>{epochs},", text)
    assert n == 1, name
    return text


# Phases 21-22: mnist_cnn.prms's layers and widths (its Elastic, Conv
# 4@3x3 relu10, Pool 2, Conv 20@3x3 relu05, Pool 2, Hidden 500 pdrop .5,
# Softmax 10, BATCH_SZ 20) on synth_hard at SEED MAIN_SEED, in the conv
# geometries that the flagship declines and the deep family takes: both
# convs 'same'; the same with a MeanLayer after the last pool; conv1 at
# stride 2; conv1 'full' with its pool at 4 (which washes the reference's
# in+F+1 booking: ceil(30/4) == ceil(32/4)).
GEOM_CONFIGS = ("mnist_same", "mnist_same_mean", "mnist_stride", "mnist_full")
GEOM_EPOCHS = 3
# The JAX package's CPU run of geometry_text("mnist_same") on synth_hard
# (jax_cpu_reference.sh): the cost on each test row and the final test
# error, in percent. The port's final test error is held to at most
# ERR_MARGIN points above it, as phase 8 holds its runs.
GEOM_JAX = dict(costs=(1310.24, 992.99, 841.96), test_err=25.25)


def geometry_text(name, epochs=GEOM_EPOCHS):
    """The .prms text of a GEOM_CONFIGS entry: params/mnist_cnn.prms with
    its geometry, SEED MAIN_SEED and NUM_EPOCHS ``epochs``."""
    import ast

    with open(os.path.join(REPO, "params", "mnist_cnn.prms")) as f:
        prms = ast.literal_eval(f.read())
    layers = [[n, dict(a)] for n, a in prms["layers"]]
    conv1, pool1, conv2 = layers[1][1], layers[2][1], layers[3][1]
    if name in ("mnist_same", "mnist_same_mean"):
        conv1["mode"] = conv2["mode"] = "same"
    if name == "mnist_same_mean":
        layers.insert(5, ["MeanLayer", {}])
    if name == "mnist_stride":
        conv1["stride"] = 2
    if name == "mnist_full":
        conv1["mode"], pool1["pool_sz"] = "full", 4
    tr = dict(prms["training_params"], SEED=MAIN_SEED, NUM_EPOCHS=epochs)
    return repr({"layers": [tuple(lyr) for lyr in layers],
                 "training_params": tr}) + "\n"


def geometry_config(name):
    """(layers, training params) of a GEOM_CONFIGS entry at synth_hard's
    28 x 28."""
    import ast

    prms = ast.literal_eval(geometry_text(name))
    layers = [[n, dict(a)] for n, a in prms["layers"]]
    layers[0][1]["img_sz"] = 28
    return layers, prms["training_params"]


def step_rows(torch, data_mod, in_ch, batch, dev):
    """A dataset's training set as the fused kernels' channel-major step
    rows (nb, C0*B, HW) and labels (nb, B), as the Trainer arranges them."""
    import numpy as np
    from theanet_tpu_torch.prms import fixdim

    xs = fixdim(data_mod.training_x)
    nb, hw = xs.shape[0] // batch, xs.shape[2] * xs.shape[3]
    x = (torch.as_tensor(xs[:nb * batch], device=dev)
         .reshape(nb, batch, in_ch, hw).transpose(1, 2)
         .reshape(nb, in_ch * batch, hw).contiguous())
    y = torch.as_tensor(np.asarray(data_mod.training_y[:nb * batch],
                                   np.int32), device=dev).reshape(nb, batch)
    return x, y


def build_net(layers, tr):
    """(net, plan) of a layer list; the plan must be a fused family's."""
    from theanet_tpu_torch.model import NeuralNet
    from theanet_tpu_torch.ops import megastep

    net = NeuralNet(layers, tr)
    plan = megastep.fused_plan(net)
    assert plan is not None, megastep.fused_decline_reason(net)
    return net, plan


def load_config(torch, name, dev):
    """(net, plan, x_steps, y_steps) of a CONFIGS or GEOM_CONFIGS entry at
    its dataset's image size and channel count, as train.py builds it."""
    import ast
    import importlib

    from theanet_tpu_torch.prms import fixdim

    if name in GEOM_CONFIGS:
        layers, tr = geometry_config(name)
        data = importlib.import_module("theanet_tpu_torch.data.synth_hard")
    else:
        prms = ast.literal_eval(config_text(name))
        layers = [[n, dict(a)] for n, a in prms["layers"]]
        tr = prms["training_params"]
        data = importlib.import_module("theanet_tpu_torch.data."
                                       + CONFIGS[name]["data"])
    shape = fixdim(data.training_x[:1]).shape
    layers[0][1]["img_sz"] = shape[3]
    if "num_maps" not in layers[0][1] and shape[1] != 1:
        layers[0][1]["num_maps"] = shape[1]
    net, plan = build_net(layers, tr)
    x, y = step_rows(torch, data, plan.spec.in_ch, net.batch_sz, dev)
    return net, plan, x, y


def family_fns(plan):
    """(kernel wrapper, twin) of a fused plan."""
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_deep as deep
    from theanet_tpu_torch.ops import megastep_mlp as mlp

    for kernel, twin in ((megastep.megastep_epoch,
                          megastep.megastep_epoch_reference),
                         (deep.deep_epoch, deep.deep_epoch_reference),
                         (mlp.mlp_epoch, mlp.mlp_epoch_reference)):
        if plan.epoch_fn is kernel:
            return kernel, twin
    raise AssertionError(f"not a fused plan: {plan.epoch_fn}")


def head_bytes(plan):
    """The route rule's head threshold of a fused plan, in bytes (the
    scratch of the one-block head the kernels once had; the rule
    takes a spec the JAX package declines when it is at most 227 KB)."""
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_deep as deep
    from theanet_tpu_torch.ops import megastep_mlp as mlp

    spec = plan.spec
    if isinstance(spec, megastep.MegaSpec):
        return megastep.flagship_head_smem(spec)
    if isinstance(spec, mlp.MlpSpec):
        spec = mlp.as_deep(spec)
    return deep.deep_head_smem(spec)


def initial_state(plan, net, dev):
    from theanet_tpu_torch.model import params_from_allwts

    return plan.kernel_layout(params_from_allwts(
        [net.allwts0[i] for i in plan.layer_idx], dev), plan.spec)


def one_step(torch, spec, kp, x, y, fns, dev):
    """One step from ``kp`` and random nonzero momenta, kernel vs twin (a
    nearest warp takes the first noise epoch whose warp has no
    near-rounding pixel). Returns (max|d| of the state, of cost and minf)."""
    from theanet_tpu_torch.ops import megastep

    gen = torch.Generator(device=dev).manual_seed(11)
    km = [0.01 * torch.randn(t.shape, generator=gen, device=dev)
          for t in kp]   # nonzero: the step must move the parameters
    for epoch in range(50):
        bits = megastep.epoch_noise_bits(7, epoch, spec, 1, dev)
        if not spec.nearest or near_rounding_pixels(
                torch, megastep, spec, bits, 0) == 0:
            break
    got = fns[0](kp, km, x[:1], y[:1], bits, 0.1, spec)
    ref = fns[1](kp, km, x[:1], y[:1], bits, 0.1, spec)
    torch.cuda.synchronize()
    d_state = max(max_abs(a, b) for a, b in zip(got[0] + got[1],
                                                ref[0] + ref[1]))
    d_cost = max_abs(got[2], ref[2])
    moved = max(max_abs(a, b) for a, b in zip(got[0], kp))
    assert bool(torch.isfinite(got[2]).all())
    assert moved > 0, "the step did not move the parameters"
    assert d_cost <= STEP_COST_ATOL, (got[2], ref[2])
    assert d_state <= STEP_ATOL, d_state
    return d_state, d_cost


def check_config(torch, name, dev, kernel):
    """One step and a step-locked epoch of a CONFIGS entry: kernel vs twin.
    Returns the worst |d| of the state."""
    from theanet_tpu_torch.ops import megastep

    net, plan, x, y = load_config(torch, name, dev)
    fns = family_fns(plan)
    assert fns[0] is kernel, (name, plan.epoch_fn)
    spec = plan.spec
    kp = initial_state(plan, net, dev)
    d1, dc1 = one_step(torch, spec, kp, x, y, fns, dev)
    km = [torch.zeros_like(t) for t in kp]
    bits = megastep.epoch_noise_bits(3, 0, spec, x.shape[0], dev)
    t0 = time.time()
    clean, flip, n_near, (p, _) = step_locked(
        torch, megastep, spec, kp, km, x, y, bits, fns=fns,
        cost_atol=STEP_COST_ATOL)
    moved = max(max_abs(a, b) for a, b in zip(p, kp))
    print(f"  {name} ({len(kp)} state tensors): one step max|d| state "
          f"{d1:.3e} cost/minf {dc1:.3e}; step-locked epoch of "
          f"{x.shape[0]} steps max|d| state {clean:.3e} ({n_near} steps with "
          f"a near-rounding pixel: {flip:.3e}); params moved {moved:.3e} "
          f"[{time.time() - t0:.1f} s]", flush=True)
    assert moved > 0
    assert clean <= STEP_ATOL and flip <= FLIP_ATOL, (clean, flip)
    return max(d1, clean)


# The deep kernel's options beyond the three configurations, at small
# shapes, with L1, L2 and max-norm on: (img, in_ch, layers).
R1 = {"L1": 1e-4, "L2": 1e-3, "momentum": 0.9, "rate": 1.0, "maxnorm": 0.9}
R2 = {"L1": 0.0, "L2": 1e-3, "momentum": 0.95, "rate": 0.5, "maxnorm": 0.7}
ELASTIC = ("ElasticLayer", dict(translation=2, zoom=1.1, magnitude=8,
                                sigma=3, pflip=0.03, angle=5,
                                invert_image=True, nearest=False))
DEEP_VARIANTS = {
    # 17 -> 15 (no pool) -> 13 -> ignore_border pool 2 -> 6 -> 5 -> ceil
    # pool 2 -> 3
    "3-levels-identity-and-ignore-border-pools": (17, 1, [
        ELASTIC,
        ("ConvLayer", dict(num_maps=3, filter_sz=3, stride=1,
                           actvn="relu05", reg=R1)),
        ("ConvLayer", dict(num_maps=4, filter_sz=3, stride=1, actvn="tanh",
                           reg=R2)),
        ("PoolLayer", dict(pool_sz=2, ignore_border=True)),
        ("ConvLayer", dict(num_maps=3, filter_sz=2, stride=1,
                           actvn="relu10", reg=R1)),
        ("PoolLayer", dict(pool_sz=2)),
        ("HiddenLayer", dict(n_out=12, pdrop=0.5, reg=R2)),
        ("SoftmaxLayer", dict(n_out=4, reg=R1))]),
    "pre-hidden-stack-with-dropout": (12, 1, [
        ("InputLayer", {}),
        ("ConvLayer", dict(num_maps=2, filter_sz=3, stride=1,
                           actvn="relu10", reg=R1)),
        ("PoolLayer", dict(pool_sz=2)),
        ("HiddenLayer", dict(n_out=16, pdrop=0.25, actvn="sigmoid",
                             reg=R2)),
        ("DropOutLayer", dict(pdrop=0.5)),
        ("HiddenLayer", dict(n_out=12, pdrop=0.5, reg=R1)),
        ("DropOutLayer", dict(pdrop=0.2)),
        ("SoftmaxLayer", dict(n_out=4, reg=R2))]),
    "flat-color-3-channels-two-hiddens": (10, 3, [
        ("ColorLayer", dict(balance=1.3, gamma=1.4, maxval=1)),
        ELASTIC,
        ("HiddenLayer", dict(n_out=20, pdrop=0.5, reg=R1)),
        ("HiddenLayer", dict(n_out=12, actvn="softplus", reg=R2)),
        ("SoftmaxLayer", dict(n_out=4, reg=R1))]),
    # 44 -> 42 (wider than a warp: the weight gradient's lanes take
    # column chunks) -> pool 2 -> 21 -> 19 -> ceil pool 2 -> 10 -> 9
    "level-wider-than-a-warp": (44, 1, [
        ("InputLayer", {}),
        ("ConvLayer", dict(num_maps=3, filter_sz=3, stride=1,
                           actvn="relu10", reg=R1)),
        ("PoolLayer", dict(pool_sz=2)),
        ("ConvLayer", dict(num_maps=4, filter_sz=3, stride=1,
                           actvn="relu05", reg=R2)),
        ("PoolLayer", dict(pool_sz=2)),
        ("ConvLayer", dict(num_maps=3, filter_sz=2, stride=1,
                           actvn="relu10", reg=R1)),
        ("HiddenLayer", dict(n_out=12, pdrop=0.5, reg=R1)),
        ("SoftmaxLayer", dict(n_out=4, reg=R2))]),
    "rbf-frozen-centers-junk-inf": (12, 1, [
        ("InputLayer", {}),
        ("ConvLayer", dict(num_maps=3, filter_sz=3, stride=1,
                           actvn="relu05", reg=R1)),
        ("PoolLayer", dict(pool_sz=2)),
        ("HiddenLayer", dict(n_out=16, reg=R2)),
        ("CenteredOutLayer", dict(n_features=8, n_classes=5, kind="RBF",
                                  learn_centers=False, reg=R1))]),
}


def phase6_variants(torch, dev):
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_deep as deep

    worst = 0.0
    for name, (img, in_ch, layers) in DEEP_VARIANTS.items():
        layers = [[n, dict(a)] for n, a in layers]
        layers[0][1].update(img_sz=img, num_maps=in_ch)
        net, plan = build_net(layers, {"SEED": 5, "BATCH_SZ": 4})
        fns = family_fns(plan)
        assert fns[0] is deep.deep_epoch, name
        spec = plan.spec
        gen = torch.Generator(device=dev).manual_seed(5)
        kp = initial_state(plan, net, dev)
        km = [0.01 * torch.randn(t.shape, generator=gen, device=dev)
              for t in kp]
        nb = 3
        x = torch.rand((nb, in_ch * spec.batch, spec.hw), generator=gen,
                       device=dev)
        y = torch.randint(0, spec.n_classes, (nb, spec.batch), generator=gen,
                          device=dev, dtype=torch.int32)
        bits = megastep.epoch_noise_bits(9, 0, spec, nb, dev)
        clean, _, _, (p1, _) = step_locked(torch, megastep, spec, kp, km, x,
                                           y, bits, fns=fns,
                                           cost_atol=STEP_COST_ATOL)
        moved = max(max_abs(a, b) for a, b in zip(p1, kp))
        y_bad = y[:1].clone()
        y_bad[0, 1] = spec.n_classes   # a label outside the classes
        cm = fns[0](kp, km, x[:1], y_bad, tuple(b[:1] for b in bits), 0.1,
                    spec)[2]
        print(f"  {name}: {nb} steps step-locked, max|d| state {clean:.3e}; "
              f"params moved {moved:.3e}; a label outside the classes: cost "
              f"{float(cm[0, 0])}", flush=True)
        assert moved > 0, "the steps did not move the parameters"
        assert clean <= STEP_ATOL, clean
        assert math.isnan(float(cm[0, 0])), cm
        worst = max(worst, clean)
    return worst


def phase6(torch, dev):
    from theanet_tpu_torch.ops import megastep_deep as deep

    worst = max(check_config(torch, name, dev, deep.deep_epoch)
                for name in ("galaxy_rbf", "logit_centered", "synth_quick"))
    return max(worst, phase6_variants(torch, dev))


def phase7(torch, dev):
    from theanet_tpu_torch.ops import megastep_mlp as mlp

    return check_config(torch, "flat_mlp", dev, mlp.mlp_epoch)


ROW = re.compile(r"^\s*(\d+)\s+(\S+)\s+([\d.]+)%\s+\(\s*([\d.]+)%\)\s+"
                 r"([\d.]+)%\s+\(\s*([\d.]+)%\)\s*$")


def epoch_rows(out):
    """The epoch table of a CLI run: [(epoch, cost, test error %)]."""
    return [(int(m.group(1)), float(m.group(2)), float(m.group(5)))
            for m in map(ROW.match, out.splitlines()) if m]


def counted_run(train, argv):
    """Run the CLI with every kernel's launch counter set to 0 just before;
    returns (output, {kernel: launches})."""
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_deep as deep
    from theanet_tpu_torch.ops import megastep_mlp as mlp

    from theanet_tpu_torch.ops import elastic_resample, fused_mlp

    fns = (megastep.megastep_epoch, deep.deep_epoch, mlp.mlp_epoch,
           elastic_resample.elastic_resample, fused_mlp.tail_forward,
           fused_mlp.tail_backward) + dp_wrappers()
    for fn in fns:
        fn.launches = 0
    out = run_cli(train, argv)
    return out, {fn.__name__: fn.launches for fn in fns}


def cli_run(train, name, family, launches, seed=None, epochs=None):
    """train.main on a CONFIGS entry (its SEED and epochs, or the given
    ones) in the working directory; checks that every epoch was one launch
    of ``family``'s kernel and none of another's. Returns the epoch rows."""
    cfg = CONFIGS[name]
    epochs = cfg["epochs"] if epochs is None else epochs
    with open(name + ".prms", "w") as f:
        f.write(config_text(name, seed, epochs))
    out, counts = counted_run(train, ["train", cfg["data"], name + ".prms"])
    want = {"megastep_epoch": 0, "deep_epoch": 0, "mlp_epoch": 0,
            "elastic_resample": 0, "tail_forward": 0, "tail_backward": 0,
            **{fn.__name__: 0 for fn in dp_wrappers()}}
    want[family] = epochs
    assert counts == want, (name, seed, counts)
    launches[family] += epochs
    assert "Device : cuda" in out
    rows = epoch_rows(out)
    assert all(math.isfinite(r[1]) for r in rows), rows
    return rows


def resume_one_epoch(train, name, launches, data=None, family="deep_epoch"):
    """Resume the one kept checkpoint of ``name`` for one epoch (on its
    CONFIGS dataset, or ``data``): one launch of ``family``'s kernel."""
    from theanet_tpu_torch.prms import load_params

    pkls = [p for p in os.listdir(".")
            if p.startswith(name) and p.endswith(".pkl")]
    assert len(pkls) == 1, pkls
    # the kept checkpoint is the last test row's; the resume trains one
    # epoch from its CUR_EPOCH on
    layers, tr, allwts = load_params(pkls[0])
    start = tr["CUR_EPOCH"]
    tr["NUM_EPOCHS"] = 1
    with open("resume.pkl", "wb") as f:
        pickle.dump({"layers": layers, "training_params": tr,
                     "allwts": allwts}, f, -1)
    out, counts = counted_run(
        train, ["train", data or CONFIGS[name]["data"], "resume.pkl"])
    assert counts[family] == 1, counts
    launches[family] += 1
    resumed = epoch_rows(out)
    assert [r[0] for r in resumed] == [start, start + 1], (start, resumed)
    assert all(math.isfinite(r[1]) for r in resumed)


def phase8(torch):
    from theanet_tpu_torch import train

    launches = {"deep_epoch": 0, "mlp_epoch": 0}
    results, sweep = {}, {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for name in CONFIGS:
                family = "mlp_epoch" if name == "flat_mlp" else "deep_epoch"
                results[name] = cli_run(train, name, family, launches)
                if name == "galaxy_rbf":
                    resume_one_epoch(train, name, launches)
            for seed in GALAXY_SWEEP:
                rows = cli_run(train, "galaxy_rbf", "deep_epoch", launches,
                               seed, GALAXY_SWEEP_EPOCHS)
                sweep[seed] = tuple(r[1] for r in rows[:-1])
        finally:
            os.chdir(cwd)
    for name, rows in results.items():
        cfg = CONFIGS[name]
        costs, final = [r[1] for r in rows[:-1]], rows[-1][2]
        print(f"  {name} on {cfg['data']}, SEED {cfg['seed']}: test-row "
              f"costs {costs} (JAX CPU {list(cfg['jax_costs'])}); final test "
              f"error {final:.2f}% (JAX CPU {cfg['jax_test_err']:.2f}%)",
              flush=True)
        assert len(costs) == len(cfg["jax_costs"]), (name, rows)
        if name != "flat_mlp":
            assert final <= cfg["jax_test_err"] + ERR_MARGIN, (name, final)
        if name == "galaxy_rbf":
            for c, cj in zip(costs, cfg["jax_costs"]):
                assert abs(c - cj) <= SEED_COST_RTOL * cj, (c, cj)
    port = [sum(sweep[s][k] for s in GALAXY_SWEEP) / len(GALAXY_SWEEP)
            for k in range(2)]
    ref = [sum(GALAXY_SWEEP_JAX[s][k] for s in GALAXY_SWEEP)
           / len(GALAXY_SWEEP) for k in range(2)]
    print(f"  galaxy_rbf, {GALAXY_SWEEP_EPOCHS} epochs at SEEDs "
          f"{GALAXY_SWEEP}: epoch-0 and epoch-2 test-row costs "
          f"{[sweep[s] for s in GALAXY_SWEEP]}, means {port} (JAX CPU "
          f"{[GALAXY_SWEEP_JAX[s] for s in GALAXY_SWEEP]}, means {ref})",
          flush=True)
    for c, cj in zip(port, ref):
        assert abs(c - cj) <= SWEEP_COST_RTOL * cj, (port, ref)
    print(f"kernel launches in the main path: {launches}", flush=True)
    return launches


def timed(torch, fn, reps):
    """ms per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def step_flops(spec):
    """Floating-point operations of one training step, from the shapes: the
    conv and dense products (forward, weight gradient and, below the top
    level, input gradient; 2 per multiply-add), a MeanLayer's scale and
    add, and 10 per state element for the regularised momentum update."""
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_deep as deep
    from theanet_tpu_torch.ops import megastep_mlp as mlp

    if isinstance(spec, megastep.MegaSpec):
        levels = [(spec.in_ch, spec.maps1, spec.filt1 * spec.c1),
                  (spec.maps1, spec.maps2, spec.filt2 * spec.c2)]
        widths = [spec.n_flat, spec.n_hid, spec.n_out]
        shapes = megastep.kernel_shapes(spec)
    else:
        if isinstance(spec, mlp.MlpSpec):
            spec = mlp.as_deep(spec)
        cins = (spec.in_ch,) + tuple(spec.maps[:-1])
        # per side, the taps of the c outputs that read the input (a
        # padded level's taps off the input are no work)
        levels = [(cin, m, sum(0 <= y * cs + f - 1 - u - pad < s_in
                               for y in range(c) for u in range(f)))
                  for cin, m, f, (s_in, pad, cs, c, _) in
                  zip(cins, spec.maps, spec.filts, spec.levels)]
        widths = ([spec.n_flat] + [ph[0] for ph in spec.pre_hidden]
                  + [spec.n_hid, spec.n_out])
        shapes = deep.deep_kernel_shapes(spec)
    B, extra = spec.batch, 0
    products = [(B * m * taps * taps * cin, k > 0)
                for k, (cin, m, taps) in enumerate(levels)]
    if getattr(spec, "mean_tail", False):
        extra += 2 * B * spec.n_flat * spec.levels[-1][4] ** 2
    if getattr(spec, "head", "") == "softaux":
        # the scores f Wt; the encoder 2 -> nah -> nao and the cross
        # weights nao -> classes, forward, weight and input gradients
        nah, nao = spec.n_aux
        products += [(B * spec.n_flat * spec.n_out, True),
                     (B * 2 * nah, False), (B * nah * nao, True),
                     (B * nao * spec.n_out, True)]
    else:
        if getattr(spec, "aux_concat", ()):
            # the frozen encoder's forward; its output widens the tail's
            # first product, whose input gradient reaches the flatten only
            nah, nao = spec.aux_concat
            extra += 2 * B * (2 * nah + nah * nao)
            extra += 2 * B * nao * widths[1] * 2
        products += [(B * a * b, bool(levels) or k > 0)
                     for k, (a, b) in enumerate(zip(widths, widths[1:]))]
    flops = sum(2 * macs * (3 if dgrad else 2) for macs, dgrad in products)
    return flops + extra + 10 * sum(r * c for r, c in shapes)


def bound(n_bytes, flops, rate=H100_F32_FLOPS):
    """(ms, what bounds it): the least time the card could take for work
    that moves ``n_bytes`` (each input read once, each output written once)
    and does ``flops``, the larger of the bytes at the HBM rate and the
    operations at ``rate`` (the f32 rate outside the tensor cores unless
    given)."""
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def epoch_bound(spec, inputs, outputs, n_steps):
    """The bound of an epoch of a fused kernel."""
    return bound(nbytes(*inputs, *outputs), n_steps * step_flops(spec))


def time_config(torch, name, dev, card, loaded=None):
    """(kernel ms, twin ms, (bound ms, bound by)) of one full epoch of a
    config (``loaded``: load_config's (net, plan, x_steps, y_steps), by
    default of CONFIGS or GEOM_CONFIGS ``name``); checks one kernel launch
    a timed call."""
    net, plan, x, y = loaded or load_config(torch, name, dev)
    kernel, twin = family_fns(plan)
    spec = plan.spec
    kp = initial_state(plan, net, dev)
    km = [torch.zeros_like(t) for t in kp]
    from theanet_tpu_torch.ops import megastep

    bits = megastep.epoch_noise_bits(3, 0, spec, x.shape[0], dev)
    saved, kernel.launches = kernel.launches, 0
    ms_k1 = timed(torch, lambda: kernel(kp, km, x, y, bits, 0.1, spec), 3)
    ms_t = timed(torch, lambda: twin(kp, km, x, y, bits, 0.1, spec), 1)
    ms_k2 = timed(torch, lambda: kernel(kp, km, x, y, bits, 0.1, spec), 3)
    # 2 warm-ups + 6 timed calls, one launch each (none on the CPU)
    assert kernel.launches == (8 if x.is_cuda else 0), kernel.launches
    kernel.launches = saved   # timing launches do not count
    ms_k = min(ms_k1, ms_k2)
    bound = epoch_bound(spec, [x, y, *bits, *kp, *km],
                        [*kp, *km, torch.empty((x.shape[0], 2))],
                        x.shape[0])
    n_img = x.shape[0] * spec.batch
    print(f"  one {name} epoch ({x.shape[0]} steps x {spec.batch}) on "
          f"{card}: kernel {ms_k1:.3f} / {ms_k2:.3f} ms "
          f"({n_img / ms_k * 1e3:,.0f} images/s), twin {ms_t:.3f} ms; bound "
          f"{bound[0]:.4f} ms ({bound[1]}); one {kernel.__name__} launch a "
          f"call; route-rule head threshold {head_bytes(plan):,} bytes",
          flush=True)
    profile_epoch(torch, lambda: kernel(kp, km, x, y, bits, 0.1, spec),
                  x.shape[0], head=(name, spec))
    kernel.launches = saved
    return ms_k, ms_t, bound


def kernel_times(prof):
    """{kernel name: (device us, launches)} of a torch.profiler run; a
    kernel of csrc/ by its name and template arguments."""
    stages = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        m = re.search(r"k_\w+(<[^>]*>)?", e.key)
        name = m.group(0) if m else re.sub(
            r"^void |at::native::|\(anonymous namespace\)::", "", e.key)[:48]
        total, count = stages.get(name, (0.0, 0))
        stages[name] = (total + t, count + e.count)
    return stages


# {configuration: (head us/step, head bound us/step, share of busy)} of the
# profiled epochs (profile_epoch's ``head``), for the kernels JSON line
HEAD_REPORT = {}
# {configuration: (device spans, steps)} of the same profiled epochs, and
# {configuration: {stage kind: (us/step, bound us/step, bound by, PyTorch
# us/step)}} of phase 9's stage lines
STAGE_SPANS = {}
STAGE_REPORT = {}


def head_bound(spec):
    """(us, what bounds it) of one step's head at ``spec``'s shape, the work
    of the k_head_* stages. Flagship: from h3d (with z3 and the dropout
    words for dz3's epilogue), wo, bo and the labels to dz3, dwo, dbo, dbh
    and (cost, minf): the three products (scores, dwo, dz3; 2 operations a
    multiply-add), the softmax (5 a score), dz3's epilogue (3 an element)
    and the two column sums. Deep: the loss from the scores to dz4 (8 a
    score), dbo and (cost, minf); RBF adds its three products over (B, NC,
    NO), ||c||^2 and its softmax; learned centers write dcenters."""
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_mlp as mlp

    B = spec.batch
    if isinstance(spec, megastep.MegaSpec):
        NH, NC = spec.n_hid, spec.n_out
        flops = 6 * B * NH * NC + 6 * B * NC + 4 * B * NH
        n_bytes = 4 * (4 * B * NH + 2 * NH * NC + 2 * NC + NH + B + 2)
        ms, by = bound(n_bytes, flops)
        return ms * 1e3, by
    if isinstance(spec, mlp.MlpSpec):
        spec = mlp.as_deep(spec)
    NO, NC = spec.n_out, spec.n_classes or spec.n_out
    flops = 9 * B * NO
    n_bytes = 4 * (2 * B * NO + NO + B + 2)
    if spec.head in ("logit", "rbf"):
        n_bytes += 4 * NC * NO
    if spec.head == "rbf":
        flops += 6 * B * NC * NO + 2 * NC * NO + 8 * B * NC
        if spec.learn_centers:
            n_bytes += 4 * NC * NO
    ms, by = bound(n_bytes, flops)
    return ms * 1e3, by


def head_line(stages, spans, busy, n_steps, name, spec):
    """Print the head stages' device time a step (the k_head_* kernels) by
    kernel name, each its span (a stage started by a programmatic
    dependent launch waits inside its span for the stage before it), and
    the head's device time (the union of their spans) beside the head's
    bound (head_bound) and its share of the busy time (the union of every
    kernel's span); record them in HEAD_REPORT[name]."""
    heads = {k: v for k, v in stages.items() if k.startswith("k_head")}
    head_us = union_us([sp for sp in spans if sp[2].startswith("k_head")])
    us = head_us / n_steps
    b_us, by = head_bound(spec)
    share = head_us / busy if busy else 0.0
    print(f"    head of {name} (B {spec.batch} x {spec.n_out}): spans "
          + ", ".join(f"{k} {t / n_steps:.2f}" for k, (t, _) in
                      sorted(heads.items()))
          + f" us/step; the head {us:.2f} us/step, {100 * share:.1f}% of "
          f"busy; bound {b_us:.3f} us/step ({by})", flush=True)
    HEAD_REPORT[name] = (us, b_us, share)


def device_spans(prof):
    """[(start us, end us, kernel name)] of every device kernel of a
    torch.profiler run (kernel_times' names)."""
    spans = []
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        m = re.search(r"k_\w+(<[^>]*>)?", e.name)
        spans.append((e.time_range.start, e.time_range.end,
                      m.group(0) if m else e.name))
    return spans


def union_us(spans):
    """The time covered by the union of ``spans``: where kernels overlap
    (a kernel started by a programmatic dependent launch runs, waiting,
    beside the one before it) each instant counts once."""
    total, end = 0.0, -math.inf
    for start, stop, _ in sorted(spans):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def profile_epoch(torch, run, n_steps, what="one epoch", top=None,
                  head=None):
    """Print the device time of each stage kernel over one epoch (or what
    ``run`` does: ``n_steps`` steps or calls) by torch.profiler, per step,
    and the device's idle share: 1 - busy time (the union of the kernels'
    spans) over the wall time, launches from the host included; ``top``
    limits the kernels listed.
    ``head`` (configuration name, spec): also print its head line
    (head_line). Returns the idle share."""
    from torch.profiler import ProfilerActivity, profile

    run()   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    stages = kernel_times(prof)
    spans = device_spans(prof)
    busy = union_us(spans)
    print(f"    torch.profiler, {what}: wall {wall_us / 1e3:.2f} ms, device "
          f"kernels busy {busy / 1e3:.2f} ms, idle share "
          f"{100 * (1 - busy / wall_us):.1f}%", flush=True)
    ranked = sorted(stages.items(), key=lambda kv: -kv[1][0])
    for name, (t, count) in ranked[:top]:
        print(f"    {name:24s} {t / n_steps:8.2f} us/step "
              f"{count / n_steps:5.1f} launches/step "
              f"{100 * t / busy:5.1f}% of busy", flush=True)
    if head is not None:
        head_line(stages, spans, busy, n_steps, *head)
        STAGE_SPANS[head[0]] = (spans, n_steps)
    return 1 - busy / wall_us


def phase9(torch, data, dev, card):
    """Each CONFIGS entry (phase 8's configurations) timed and profiled,
    then the stage lines of mnist_cnn (phase 5's profile, or one taken
    here), galaxy_rbf and flat_mlp and the plan mirrors' check:
    {"deep_epoch": galaxy_rbf's times, "mlp_epoch": flat_mlp's}."""
    times = {name: time_config(torch, name, dev, card) for name in CONFIGS}
    if "mnist_cnn" not in STAGE_SPANS:
        phase5(torch, data, dev, card)
    for name in STAGE_CONFIGS:
        stage_lines(torch, name, dev, card)
    plan_mirrors()
    return {"deep_epoch": times["galaxy_rbf"], "mlp_epoch": times["flat_mlp"]}


# The three stage kinds ops/stage_plan.py plans (csrc/stages.cuh), by their
# kernels' names, and the PyTorch call each is measured against (a
# yardstick timed outside the path, TF32 off; the port never calls it).
STAGE_KINDS = {
    "conv weight gradient": (("k_wgrad",), "torch.nn.grad.conv2d_weight"),
    "conv input gradient": (("k_conv2_dgrad_pool1_bwd", "k_conv_dgrad",
                             "k_conv_dgrad_tiled"),
                            "torch.nn.grad.conv2d_input"),
    "dense products": (("k_gemm_sk",), "torch.matmul"),
}
STAGE_CONFIGS = ("mnist_cnn", "galaxy_rbf", "flat_mlp")
STAGE_REPS = 50


def stage_shapes(spec):
    """(weight-gradient levels, input-gradient levels, products) of one
    step at ``spec`` (ops/stage_plan.py's ConvGeom and (name, M, N, K))."""
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import stage_plan as sp

    if isinstance(spec, megastep.MegaSpec):
        lv = sp.flagship_levels(spec)
        return lv, lv[:1], sp.flagship_products(spec)
    lv = sp.deep_levels(spec)
    return lv, lv[1:], sp.deep_products(spec)


def stage_bounds(spec):
    """{stage kind: (us, what bounds it)}: the least time of one step's
    work of each kind (each input read once, each output written once;
    2 operations a multiply-add). The weight gradient reads dz and the
    level's input and writes the weights and bias; the input gradient
    reads dz and the weights and writes the input's gradient (the
    flagship's epilogue also reads z1 and p1 and writes dz1); a product
    reads A and B and writes C (a hidden layer's also the dropout words
    and h)."""
    from theanet_tpu_torch.ops import megastep

    levels, dlevels, products = stage_shapes(spec)
    flagship = isinstance(spec, megastep.MegaSpec)
    out = {}
    n_bytes = flops = 0
    for g in levels:
        taps = g.F * g.F * g.Cin
        flops += 2 * g.B * g.M * g.e * g.e * taps + g.B * g.M * g.e * g.e
        n_bytes += 4 * (g.B * g.M * g.c * g.c + g.B * g.Cin * g.W * g.W
                        + g.M * (taps + 1))
    out["conv weight gradient"] = (n_bytes, flops)
    n_bytes = flops = 0
    for g in dlevels:
        flops += 2 * g.B * g.M * g.e * g.e * g.F * g.F * g.Cin
        n_bytes += 4 * (g.B * g.M * g.c * g.c + g.M * g.F * g.F * g.Cin
                        + g.B * g.Cin * g.W * g.W)
        if flagship:
            n_bytes += 4 * (2 * g.B * g.Cin * spec.c1 ** 2)
    out["conv input gradient"] = (n_bytes, flops)
    n_bytes = flops = 0
    for name, M, N, K in products:
        flops += 2 * M * N * K
        n_bytes += 4 * (M * K + K * N + M * N)
        if name == "z3" or name.startswith("pre"):
            n_bytes += 8 * M * N
    out["dense products"] = (n_bytes, flops)
    return {k: ((lambda ms, by: (ms * 1e3, by))(*bound(b, f)) if f else
                (0.0, "none")) for k, (b, f) in out.items()}


def stage_yardstick(torch, spec, kind, dev):
    """us per step of the PyTorch calls of one step's work of ``kind``
    (STAGE_KINDS' call per level or product, at its shapes; CUDA events
    over STAGE_REPS steps after a warm-up), or None when the step has
    none."""
    levels, dlevels, products = stage_shapes(spec)
    gen = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda *shape: torch.randn(shape, device=dev, generator=gen)
    calls = []
    if kind == "conv weight gradient":
        for g in levels:
            x, dz = rnd(g.B, g.Cin, g.W, g.W), rnd(g.B, g.M, g.c, g.c)
            calls.append(lambda x=x, dz=dz, g=g: torch.nn.grad.conv2d_weight(
                x, (g.M, g.Cin, g.F, g.F), dz, stride=g.cs, padding=g.pad))
    elif kind == "conv input gradient":
        for g in dlevels:
            w, dz = rnd(g.M, g.Cin, g.F, g.F), rnd(g.B, g.M, g.c, g.c)
            calls.append(lambda w=w, dz=dz, g=g: torch.nn.grad.conv2d_input(
                (g.B, g.Cin, g.W, g.W), w, dz, stride=g.cs, padding=g.pad))
    else:
        for _, M, N, K in products:
            a, b = rnd(M, K), rnd(K, N)
            calls.append(lambda a=a, b=b: torch.matmul(a, b))
    if not calls:
        return None
    ms = timed(torch, lambda: [c() for c in calls], STAGE_REPS)
    return ms * 1e3


def attributed_us(spans):
    """{kernel name: us}: each instant of the trace attributed to the
    earliest-started kernel running then. A kernel started by programmatic
    dependent launch is resident, waiting, while the kernel before it
    runs; that time is the earlier kernel's."""
    import heapq

    spans = sorted(spans)
    edges = sorted({t for a, b, _ in spans for t in (a, b)})
    out, active, i = {}, [], 0
    for t0, t1 in zip(edges, edges[1:]):
        while i < len(spans) and spans[i][0] <= t0:
            heapq.heappush(active, spans[i])
            i += 1
        while active and active[0][1] <= t0:
            heapq.heappop(active)
        if active:
            name = active[0][2]
            out[name] = out.get(name, 0.0) + (t1 - t0)
    return out


def stage_lines(torch, name, dev, card):
    """Print, for each stage kind of STAGE_KINDS, its device time a step in
    the profiled epoch of ``name`` (attributed_us: the instants when one of
    its kernels is the earliest-started one running), its bound
    (stage_bounds) and its PyTorch yardstick (stage_yardstick); record
    them in STAGE_REPORT[name]."""
    spans, n_steps = STAGE_SPANS[name]
    spec = plan_spec(name, None)
    bounds = stage_bounds(spec)
    owned = attributed_us(spans)
    rep = STAGE_REPORT.setdefault(name, {})
    print(f"  stages of {name} (B {spec.batch}) on {card}:", flush=True)
    for kind, (kernels, lib) in STAGE_KINDS.items():
        mine = [sp for sp in spans if sp[2].startswith(kernels)]
        us = sum(t for k, t in owned.items()
                 if k.startswith(kernels)) / n_steps
        b_us, by = bounds[kind]
        lib_us = stage_yardstick(torch, spec, kind, dev)
        rep[kind] = (us, b_us, by, lib_us)
        names = sorted({sp[2] for sp in mine})
        print(f"    {kind}: {us:.2f} us/step ({', '.join(names) or 'none'}),"
              f" bound {b_us:.3f} us/step ({by}), PyTorch {lib} "
              + (f"{lib_us:.2f} us/step" if lib_us is not None else "none"),
              flush=True)


def plan_spec(name, batch):
    """The fused spec a PLAN_CONFIGS configuration trains on, at BATCH_SZ
    ``batch`` (None: its own)."""
    from theanet_tpu_torch.model import NeuralNet
    from theanet_tpu_torch.ops import megastep

    if name in HEAD_CONFIGS:
        layers, tr = head_config(name)
    elif name == GTSRB:
        layers, tr = gtsrb_config()
    else:
        layers, tr, _ = dp_config(name)
    if batch is not None:
        tr = dict(tr, BATCH_SZ=batch)
    plan = megastep.fused_plan(NeuralNet(layers, tr))
    assert plan is not None, name
    return plan.spec


# Wide levels whose plans the mirrors are held to beside PLAN_CONFIGS':
# dgrad_plan's (B, Cin, W, M, F) with one row a band and a canvas wider
# than the block, or a band wider than DG_MAX_THREADS, and the levels just
# inside and past the shared-memory limit the route rule declines by;
# wgrad_plan's (B, M, Cin, F, e, cs) with rows wider than the block, in map
# groups, and at that limit
WIDE_DGRAD = ((20, 4, 256, 12, 3), (20, 4, 510, 12, 5), (4, 2, 1030, 2, 3),
              (1, 1, 1100, 1, 5), (4, 1, 172, 64, 5), (4, 1, 173, 64, 5))
WIDE_DGRAD_TILE = ((20, 100, 21, 150, 4), (20, 150, 9, 250, 4),
                   (256, 150, 9, 250, 4), (3000, 64, 20, 64, 3),
                   (20, 64, 173, 64, 5), (4, 256, 1100, 256, 7),
                   (1, 32, 1, 1, 2), (20, 31, 21, 150, 4))
WIDE_WGRAD = ((4, 2, 1, 3, 1028, 1), (20, 4, 64, 5, 172, 1),
              (20, 4, 64, 5, 174, 1), (20, 4, 64, 5, 177, 1),
              (20, 4, 64, 5, 178, 1), (3000, 4, 3, 5, 300, 2))


def plan_mirrors():
    """Hold ops/stage_plan.py's mirrors to the C on the card: every stage
    plan of every PLAN_CONFIGS configuration equal to stages.cuh's
    (stage_*_plan exports), and the mirrored workspace to the library's
    *_workspace_floats, the floats the wrappers allocate."""
    from theanet_tpu_torch.ops import _build, megastep
    from theanet_tpu_torch.ops import megastep_mlp as mlp
    from theanet_tpu_torch.ops import stage_plan as sp

    n_plans = 0
    for name, batch in PLAN_CONFIGS:
        spec = plan_spec(name, batch)
        if isinstance(spec, megastep.MegaSpec):
            lib, prefix = "megastep", "megastep"
            mirror_ws = sp.megastep_workspace_floats(spec)
        else:
            if isinstance(spec, mlp.MlpSpec):
                spec = mlp.as_deep(spec)
            lib, prefix = "megastep_deep", "deep"
            mirror_ws = sp.deep_workspace_floats(spec)
        levels, dlevels, products = stage_shapes(spec)
        want, got = [], []
        for g in levels:
            want.append(tuple(sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e,
                                            g.cs)))
            got.append(_build.stage_plan_c("stage_wgrad_plan", g.B, g.M,
                                           g.Cin, g.F, g.e, g.cs, lib=lib))
        for g in dlevels:
            want.append(tuple(sp.dgrad_plan(g.B, g.Cin, g.W, g.M, g.F)))
            got.append(_build.stage_plan_c("stage_dgrad_plan", g.B, g.Cin,
                                           g.W, g.M, g.F, lib=lib))
            want.append(tuple(sp.dgrad_tile_plan(g.B, g.Cin, g.W, g.M,
                                                 g.F)))
            got.append(_build.stage_plan_c("stage_dgrad_tile_plan", g.B,
                                           g.Cin, g.W, g.M, g.F, lib=lib))
        for _, M, N, K in products:
            want.append(tuple(sp.gemm_plan(M, N, K)))
            got.append(_build.stage_plan_c("stage_gemm_plan", M, N, K,
                                           lib=lib))
        assert want == got, (name, batch, want, got)
        c_ws = _build.workspace_floats_c(prefix, spec)
        assert mirror_ws == c_ws, (name, batch, mirror_ws, c_ws)
        n_plans += len(want)
    for shape in WIDE_DGRAD:
        want = tuple(sp.dgrad_plan(*shape))
        got = _build.stage_plan_c("stage_dgrad_plan", *shape)
        assert want == got, (shape, want, got)
    for shape in WIDE_WGRAD:
        want = tuple(sp.wgrad_plan(*shape))
        got = _build.stage_plan_c("stage_wgrad_plan", *shape)
        assert want == got, (shape, want, got)
    for shape in WIDE_DGRAD_TILE:
        want = tuple(sp.dgrad_tile_plan(*shape))
        got = _build.stage_plan_c("stage_dgrad_tile_plan", *shape,
                                  lib="megastep_deep")
        assert want == got, (shape, want, got)
    n_wide = len(WIDE_DGRAD) + len(WIDE_WGRAD) + len(WIDE_DGRAD_TILE)
    print(f"  plan mirrors: {n_plans} stage plans of {len(PLAN_CONFIGS)} "
          f"configurations and {n_wide} of wide levels equal to "
          "csrc/stages.cuh's, and each mirrored workspace equal to its "
          "library's *_workspace_floats", flush=True)


# ----------------------------------------------------------- phases 10-12

# The per-layer slice: params/mnist_cnn.prms with FUSED_TAIL and the
# ElasticLayer's 'method': 'pallas', SEED pinned to MAIN_SEED, trained for
# SLICE_EPOCHS and then resumed for one more. The JAX package's CPU run of
# the same .prms for SLICE_EPOCHS + 1 epochs (jax_cpu_reference.sh, which
# writes it with slice_text): the cost on each test row and the final test
# error, in percent. The port draws its own noise (a torch.Generator, not
# JAX's keys), so the final test error is held to within SLICE_ERR_MARGIN.
SLICE_EPOCHS = 2
SLICE_JAX = dict(costs=(1280.17, 965.40, 832.94), test_err=23.95)
SLICE_ERR_MARGIN = 3.0
# phase 10: nearest copies a pixel and must agree exactly; a bilinear tap
# sum rounds each operation in the plain version's order, expected 0 too
ELASTIC_BILINEAR_ATOL = 1e-6
# phase 11: each output of the tail sums over up to 720 terms in the
# kernel's fixed order, the plain version's in cuBLAS's
TAIL_ATOL = 1e-5


def slice_text(epochs, seed=MAIN_SEED, fused_tail=True, method="pallas"):
    """params/mnist_cnn.prms with NUM_EPOCHS, SEED, FUSED_TAIL and the
    ElasticLayer's method set."""
    with open(os.path.join(REPO, "params", "mnist_cnn.prms")) as f:
        text = f.read()
    inv, n_ep = "'invert_image': True,", "'NUM_EPOCHS':          101,"
    assert inv in text and n_ep in text
    text = text.replace(inv, f"{inv} 'method': {method!r},")
    return text.replace(n_ep, f"'NUM_EPOCHS':          {epochs}, "
                        f"'SEED': {seed}, 'FUSED_TAIL': {fused_tail},")


ELASTIC_CASES = {
    # name: (batch, channels, side, config beyond img_sz)
    "mnist_cnn 20x1x28x28 nearest": (20, 1, 28, dict(
        translation=2, zoom=1.1, magnitude=60, sigma=15, pflip=0.03,
        angle=5, nearest=True, invert_image=True)),
    "20x3x32x32 bilinear": (20, 3, 32, dict(
        translation=2, zoom=1.1, magnitude=8, sigma=3, pflip=0.03, angle=5,
        invert_image=True)),
    "4x2x48x48 bilinear (hw > 1600)": (4, 2, 48, dict(
        translation=3, zoom=1.2, magnitude=20, sigma=4, pflip=0.1,
        angle=10)),
}


def elastic_inputs(torch, case, dev, seed):
    """(x, ty, tx, words, cfg) of an ELASTIC_CASES entry: synth_hard images
    for one channel, uniform noise otherwise; the warp and the flip words
    drawn as the ElasticLayer draws them."""
    from theanet_tpu_torch.ops import elastic as el

    b, c, side, kw = ELASTIC_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(seed)
    if c == 1 and side == 28:
        from theanet_tpu_torch.data import synth_hard
        x = torch.as_tensor(synth_hard.training_x[:b], device=dev).reshape(
            b, 1, 28, 28)
    else:
        x = torch.rand((b, c, side, side), generator=gen, device=dev)
    cfg = el.ElasticConfig(img_sz=side, **kw)
    ty, tx = el.clip_warp(el.sample_warp(gen, cfg, side, side, dev), side,
                          side)
    words = el.draw_flip_words(gen, x.shape, dev)
    return x.contiguous(), ty.contiguous(), tx.contiguous(), words, cfg


def phase10(torch, dev, card):
    import torch.nn.functional as F
    from theanet_tpu_torch.ops.elastic_resample import (
        elastic_resample, elastic_resample_reference)

    worst = 0.0
    saved = elastic_resample.launches
    for k, case in enumerate(ELASTIC_CASES):
        case_worst = 0.0
        for seed in range(3):
            x, ty, tx, words, cfg = elastic_inputs(torch, case, dev,
                                                   10 * k + seed)
            kw = dict(nearest=cfg.nearest, pflip=cfg.pflip,
                      invert=cfg.invert_image)
            got = elastic_resample(x, ty, tx, words, **kw)
            ref = elastic_resample_reference(x, ty, tx, words, **kw)
            torch.cuda.synchronize()
            err = max_abs(got, ref)
            moved = max_abs(got, 1.0 - x if cfg.invert_image else x)
            assert bool(torch.isfinite(got).all()) and moved > 0, case
            assert err <= (0.0 if cfg.nearest else ELASTIC_BILINEAR_ATOL), \
                (case, seed, err)
            case_worst = max(case_worst, err)
        worst = max(worst, case_worst)
        print(f"  {case}: kernel vs plain, 3 warps, max|d| {case_worst:.3e}",
              flush=True)
    # times at mnist_cnn's batch
    x, ty, tx, words, cfg = elastic_inputs(torch, next(iter(ELASTIC_CASES)),
                                           dev, 0)
    kw = dict(nearest=True, pflip=cfg.pflip, invert=True)
    b, c, h, w = x.shape
    grid = torch.stack([tx / (w - 1) * 2 - 1, ty / (h - 1) * 2 - 1], dim=-1)
    grid = grid.expand(b, h, w, 2).contiguous()
    ms = timed(torch, lambda: elastic_resample(x, ty, tx, words, **kw), 2000)
    plain = timed(torch, lambda: elastic_resample_reference(
        x, ty, tx, words, **kw), 500)
    lib = timed(torch, lambda: F.grid_sample(
        x, grid, mode="nearest", align_corners=True), 2000)
    ms2 = timed(torch, lambda: elastic_resample(x, ty, tx, words, **kw), 2000)
    profile_epoch(torch, lambda: [elastic_resample(x, ty, tx, words, **kw)
                                  for _ in range(200)], 200,
                  "200 kernel calls")
    elastic_resample.launches = saved   # comparison launches do not count
    # per element: the invert and the flip (nearest copies)
    bnd = bound(nbytes(x, ty, tx, words, x), 2 * x.numel())
    print(f"  mnist_cnn batch on {card}: kernel {ms * 1e3:.2f} / "
          f"{ms2 * 1e3:.2f} us per launch, plain {plain * 1e3:.2f} us, "
          f"F.grid_sample (nearest, align_corners; yardstick only) "
          f"{lib * 1e3:.2f} us; bound {bnd[0] * 1e3:.4f} us ({bnd[1]})",
          flush=True)
    return worst, (min(ms, ms2), plain, bnd), lib


TAIL_SHAPE = (20, 720, 500, 10)   # mnist_cnn: x (B, K), W1 (K, NH), W2 (NH, O)


def tail_inputs(torch, dev, rows=None):
    """mnist_cnn's tail weights (its SEED-1 init), a (rows, 720) batch of
    rectified features, and g = dL/dlogp of the NLL of random labels."""
    from theanet_tpu_torch.model import params_from_allwts

    net, _ = load_flagship(torch)
    (w1, b1), (w2, b2) = params_from_allwts(net.allwts0[5:7], dev)
    B, K, NH, O = TAIL_SHAPE
    B = rows or B
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.clamp(torch.randn((B, K), generator=gen, device=dev), min=0.0)
    y = torch.randint(0, O, (B,), generator=gen, device=dev)
    g = torch.zeros((B, O), device=dev)
    g[torch.arange(B, device=dev), y] = -1.0 / B
    words = torch.randint(-2**31, 2**31, (B, NH), dtype=torch.int32,
                          generator=gen, device=dev)
    return x, w1, b1, w2, b2, words, g


def phase11(torch, dev, card):
    from theanet_tpu_torch.ops import fused_mlp as fm

    saved = (fm.tail_forward.launches, fm.tail_backward.launches)
    worst_f = worst_b = 0.0
    cases = [(slope, train, None) for slope in (0.01, 0.0, 1.0)
             for train in (True, False)] + [(0.01, False, 10000)]
    for slope, train, rows in cases:
        x, w1, b1, w2, b2, words, g = tail_inputs(torch, dev, rows)
        spec = fm.FusedTailSpec(slope=slope, pdrop=0.5, train=train)
        got = fm.tail_forward(x, w1, b1, w2, b2, words, spec)
        ref = fm.tail_forward_reference(x, w1, b1, w2, b2, words, spec)
        logp, h, mask = ref
        gb = fm.tail_backward(x, w1, w2, h, mask, logp, g, spec)
        rb = fm.tail_backward_reference(x, w1, w2, h, mask, logp, g, spec)
        torch.cuda.synchronize()
        d_f = max(max_abs(a, b) for a, b in zip(got, ref))
        d_b = max(max_abs(a, b) for a, b in zip(gb, rb))
        assert all(bool(torch.isfinite(t).all()) for t in got + gb)
        assert d_f <= TAIL_ATOL and d_b <= TAIL_ATOL, (slope, train, d_f, d_b)
        kept = float(got[2].mean())
        print(f"  slope {slope}, pdrop .5, {'train' if train else 'eval'}, "
              f"{x.shape[0]} rows: max|d| forward {d_f:.3e} (logp, h, mask; "
              f"kept {kept:.3f}), backward {d_b:.3e} (dx, dW1, db1, dW2, db2)",
              flush=True)
        worst_f, worst_b = max(worst_f, d_f), max(worst_b, d_b)
    x, w1, b1, w2, b2, words, g = tail_inputs(torch, dev)
    spec = fm.FusedTailSpec(slope=0.01, pdrop=0.5, train=True)
    logp, h, mask = fm.tail_forward_reference(x, w1, b1, w2, b2, words, spec)
    B, K, NH, O = TAIL_SHAPE
    fwd = (lambda: fm.tail_forward(x, w1, b1, w2, b2, words, spec),
           lambda: fm.tail_forward_reference(x, w1, b1, w2, b2, words, spec))
    bwd = (lambda: fm.tail_backward(x, w1, w2, h, mask, logp, g, spec),
           lambda: fm.tail_backward_reference(x, w1, w2, h, mask, logp, g,
                                              spec))
    out = {}
    for name, (kern, plain) in (("forward", fwd), ("backward", bwd)):
        k1 = timed(torch, kern, 1000)
        p = timed(torch, plain, 500)
        k2 = timed(torch, kern, 1000)
        out[name] = (min(k1, k2), p)
        print(f"  tail {name} at {TAIL_SHAPE[:2]} x {TAIL_SHAPE[2:]} on "
              f"{card}: kernel {k1 * 1e3:.2f} / {k2 * 1e3:.2f} us per launch, "
              f"plain {p * 1e3:.2f} us", flush=True)
    profile_epoch(torch, lambda: [(fwd[0](), bwd[0]()) for _ in range(200)],
                  200, "200 forward + backward kernel calls")
    fm.tail_forward.launches, fm.tail_backward.launches = saved
    f_bound = bound(nbytes(x, w1, b1, w2, b2, words, logp, h, mask),
                    2 * B * K * NH + 2 * B * NH * O)
    b_bound = bound(nbytes(x, w1, w2, h, mask, logp, g, x, w1, b1, w2, b2),
                    2 * (2 * B * K * NH + 2 * B * NH * O))
    print(f"  bounds: forward {f_bound[0] * 1e3:.4f} us ({f_bound[1]}), "
          f"backward {b_bound[0] * 1e3:.4f} us ({b_bound[1]})", flush=True)
    return ((worst_f, (*out["forward"], f_bound)),
            (worst_b, (*out["backward"], b_bound)))


def slice_trainer(torch, fused_tail, method):
    """A Trainer of the slice (per-layer: MEGAFUSED off) on synth_hard."""
    import ast

    from theanet_tpu_torch.data import synth_hard
    from theanet_tpu_torch.model import NeuralNet
    from theanet_tpu_torch.trainer import Trainer

    prms = ast.literal_eval(slice_text(1, fused_tail=fused_tail,
                                       method=method))
    layers = [[n, dict(a)] for n, a in prms["layers"]]
    layers[0][1]["img_sz"] = 28
    tr = dict(prms["training_params"], MEGAFUSED=False)
    net = NeuralNet(layers, tr)
    assert net.fused_tail == fused_tail
    return Trainer(net, synth_hard.training_x, synth_hard.training_y,
                   synth_hard.testing_x, synth_hard.testing_y)


def phase12(torch, card):
    from theanet_tpu_torch import train
    from theanet_tpu_torch.prms import load_params

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            with open("mnist_cnn.prms", "w") as f:
                f.write(slice_text(SLICE_EPOCHS))
            fresh, c1 = counted_run(train, ["train", "synth_hard",
                                            "mnist_cnn.prms"])
            pkls = [p for p in os.listdir(".") if p.endswith(".pkl")]
            assert len(pkls) == 1, pkls
            layers, tr, allwts = load_params(pkls[0])
            assert tr["CUR_EPOCH"] == SLICE_EPOCHS, tr["CUR_EPOCH"]
            tr["NUM_EPOCHS"] = 1
            with open("resume.pkl", "wb") as f:
                pickle.dump({"layers": layers, "training_params": tr,
                             "allwts": allwts}, f, -1)
            resumed, c2 = counted_run(train, ["train", "synth_hard",
                                              "resume.pkl"])
        finally:
            os.chdir(cwd)
    steps = 12000 // 20
    # the final full-set row's forwards: windows of the boundary's
    # TEST_SAMP_SZ // BATCH_SZ batches over the 600 training and the 100
    # test batches (Trainer.evaluate_full)
    win = tr.get("TEST_SAMP_SZ", 0) // tr["BATCH_SZ"]
    n_final = -(-steps // win) + -(-(2000 // 20) // win) if win else 2
    for out, counts, epochs in ((fresh, c1, SLICE_EPOCHS), (resumed, c2, 1)):
        assert "Device : cuda" in out
        assert "Epoch   Cost  Tr_Error Tr_P(MLE)    Te_Error Te_P(MLE)" in out
        # an eval window is one forward of the whole window: 2 per test
        # row (test and train windows), then the final row's
        n_eval = 2 * epochs + n_final
        want = {"megastep_epoch": 0, "deep_epoch": 0, "mlp_epoch": 0,
                "elastic_resample": epochs * steps,
                "tail_forward": epochs * steps + n_eval,
                "tail_backward": epochs * steps,
                **{fn.__name__: 0 for fn in dp_wrappers()}}
        assert counts == want, (counts, want)
    rows = epoch_rows(fresh)[:-1] + epoch_rows(resumed)
    assert [r[0] for r in rows] == [0, 1, 2, 3], rows
    assert all(math.isfinite(r[1]) for r in rows), rows
    final = rows[-1][2]
    print(f"  per-layer slice, SEED {MAIN_SEED}: test-row costs "
          f"{[r[1] for r in rows[:-1]]} (JAX CPU {list(SLICE_JAX['costs'])}); "
          f"final test error {final:.2f}% (JAX CPU {SLICE_JAX['test_err']:.2f}%"
          f", bound +-{SLICE_ERR_MARGIN})", flush=True)
    assert abs(final - SLICE_JAX["test_err"]) <= SLICE_ERR_MARGIN, final
    launches = {k: c1[k] + c2[k] for k in
                ("elastic_resample", "tail_forward", "tail_backward")}
    print(f"kernel launches in the main path: {launches}", flush=True)

    from theanet_tpu_torch.ops import elastic_resample, fused_mlp

    saved = (elastic_resample.elastic_resample.launches,
             fused_mlp.tail_forward.launches, fused_mlp.tail_backward.launches)
    for fused_tail, method in ((True, "pallas"), (False, "auto"), (True,
                                                                   "pallas")):
        tr = slice_trainer(torch, fused_tail, method)
        ms = timed(torch, tr.run_epoch, 1)
        print(f"  one per-layer mnist_cnn epoch ({tr.n_train_batches} steps x "
              f"20) on {card}, FUSED_TAIL {fused_tail}, method {method!r}: "
              f"{ms:.1f} ms", flush=True)
    # the last trainer is the slice's (FUSED_TAIL and 'pallas')
    profile_epoch(torch, lambda: [tr._train_batch(i, i, 0.1)
                                  for i in range(50)], 50,
                  "50 per-layer steps", top=12)
    (elastic_resample.elastic_resample.launches,
     fused_mlp.tail_forward.launches,
     fused_mlp.tail_backward.launches) = saved
    return launches


# ----------------------------------------------------------- phases 13-14

# phase 13: the conv kernel (csrc/conv3x3.cu) against its plain version,
# (B, C, H, M): bench.py's wide conv2, the shapes of
# tests/test_conv_pallas.py, one that fills no tile evenly (72 maps,
# 11x11 outputs, depth 9 x 24 = 216), and the ragged edges of the
# tensor-core tiling: one output pixel, 28 output rows (not a whole number
# of 4-row strips) and C, M past one tile (136 channels, 200 maps)
CONV_WIDE = (256, 64, 27, 128)
CONV_CASES = [CONV_WIDE, (4, 16, 9, 8), (2, 32, 12, 16), (8, 8, 27, 8),
              (6, 16, 9, 8), (4, 16, 11, 8), (3, 24, 13, 72), (1, 16, 3, 8),
              (5, 40, 30, 24), (2, 136, 9, 200)]
# The inputs are at a trained net's scales (activations in [0, 1), weights
# of std 0.5 / sqrt(9 C), dz at a mean loss's 1 / sqrt(B O O)), so z and dw
# are O(1) and dx about 1e-2. Each of z, dx and dw is held to its own
# bound, CONV_REL times its largest |plain value|. f32: the kernel and the
# plain version sum the same products in other orders (5.8e-7 relative
# measured on z at the wide shape on an H100). bf16: both round one f32
# sum to bf16, so they differ by at most one ulp where the two sums
# straddle a rounding boundary, and bf16 keeps 8 significant bits.
CONV_REL = {"float32": 2.0 ** -18, "bfloat16": 2.0 ** -7}


def conv_inputs(torch, shape, dtype, dev, seed=0):
    B, C, H, M = shape
    O = H - 2
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((B, C, H, H), generator=gen, device=dev)
    w = torch.randn((M, C, 3, 3), generator=gen, device=dev) * (
        0.5 / math.sqrt(9 * C))
    dz = torch.randn((B, M, O, O), generator=gen, device=dev) / math.sqrt(
        B * O * O)
    return x.to(dtype), w.to(dtype), dz.to(dtype)


def conv_bounds(shape, dtype):
    """(forward, backward) bounds of the conv at ``shape``: 2 B M C 9 O^2
    operations forward and twice that backward, at the dtype's peak; each
    input read once and each output written once."""
    B, C, H, M = shape
    O = H - 2
    size = 2 if dtype == "bfloat16" else 4
    rate = H100_BF16_FLOPS if dtype == "bfloat16" else H100_F32_FLOPS
    fl = 2 * B * M * C * 9 * O * O
    x, w, z = B * C * H * H * size, M * C * 9 * size, B * M * O * O * size
    return (bound(x + w + z, fl, rate), bound(x + w + z + x + w, 2 * fl,
                                              rate))


# the stages of conv3x3_forward and conv3x3_backward, by kernel name (the
# conv body is the forward, or the backward's dx)
CONV_STAGES = (("k_to_cl", "layout pass"), ("k_wprep", "weight table"),
               ("k_conv", None), ("k_wgrad", "dw slices"),
               ("k_dw_reduce", "slice sum"))


def conv_stage_line(torch, fn, what, n=10):
    """Each stage's device us a call of a conv3x3 entry, over n calls of fn
    after a warm-up call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    times = {}
    for name, (t, _) in kernel_times(prof).items():
        key = re.sub(r"<.*", "", name)
        times[key] = times.get(key, 0.0) + t / n
    parts = [f"{label or ('forward' if what == 'forward' else 'dx')} "
             f"{times[key]:.2f}" for key, label in CONV_STAGES
             if key in times]
    return ", ".join(parts) + f" us (sum {sum(times.values()):.2f})"


def phase13(torch, dev, card):
    from torch.nn.grad import conv2d_input, conv2d_weight
    import torch.nn.functional as F
    from theanet_tpu_torch.ops import conv3x3 as cv

    saved = (cv.conv3x3_forward.launches, cv.conv3x3_backward.launches)
    worst = {"forward": 0.0, "backward": 0.0}
    for shape in CONV_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x, w, dz = conv_inputs(torch, shape, dtype, dev)
            got = cv.conv3x3_forward(x, w)
            ref = cv.conv3x3_forward_reference(x, w)
            gdx, gdw = cv.conv3x3_backward(x, w, dz)
            rdx, rdw = cv.conv3x3_backward_reference(x, w, dz)
            torch.cuda.synchronize()
            assert got.dtype == gdx.dtype == gdw.dtype == dtype
            assert all(bool(torch.isfinite(t).all()) for t in (got, gdx,
                                                               gdw))
            # two runs of the backward agree to the bit (no atomics)
            again = cv.conv3x3_backward(x, w, dz)
            assert torch.equal(again[1], gdw) and torch.equal(again[0], gdx)
            d, line = {}, []
            for what, g, r in (("z", got, ref), ("dx", gdx, rdx),
                               ("dw", gdw, rdw)):
                d[what] = max_abs(g.float(), r.float())
                lim = CONV_REL[name] * float(r.float().abs().max())
                line.append(f"{what} {d[what]:.3e} (bound {lim:.3e})")
                assert d[what] <= lim, (shape, name, what, d[what], lim)
            print(f"  {shape} {name}: max|d| " + ", ".join(line)
                  + "; backward bit-equal over two runs", flush=True)
            worst["forward"] = max(worst["forward"], d["z"])
            worst["backward"] = max(worst["backward"], d["dx"], d["dw"])
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        x, w, dz = conv_inputs(torch, CONV_WIDE, dtype, dev)
        fwd = (lambda: cv.conv3x3_forward(x, w),
               lambda: cv.conv3x3_forward_reference(x, w),
               lambda: F.conv2d(x, w))
        bwd = (lambda: cv.conv3x3_backward(x, w, dz),
               lambda: cv.conv3x3_backward_reference(x, w, dz),
               lambda: (conv2d_input(x.shape, w, dz),
                        conv2d_weight(x, w.shape, dz)))
        f_bound, b_bound = conv_bounds(CONV_WIDE, name)
        B, C, H, M = CONV_WIDE
        gflop = 2 * B * M * C * 9 * (H - 2) ** 2 / 1e9
        for what, (kern, plain, lib), bnd in (("forward", fwd, f_bound),
                                              ("backward", bwd, b_bound)):
            k1 = timed(torch, kern, 10)
            p = timed(torch, plain, 5)
            lb = timed(torch, lib, 10)
            k2 = timed(torch, kern, 10)
            k = min(k1, k2)
            fl = gflop * (1 if what == "forward" else 2)
            times[(what, name)] = (k, p, bnd, lb)
            print(f"  conv3x3 {what} at {CONV_WIDE} {name} on {card}: kernel"
                  f" {k1:.4f} / {k2:.4f} ms ({fl / k:.1f} TFLOP/s, "
                  f"{100 * bnd[0] / k:.1f}% of the bound), plain {p:.3f} ms,"
                  f" cuDNN (yardstick only) {lb:.4f} ms (kernel / cuDNN "
                  f"{k / lb:.2f}); bound {bnd[0]:.4f} ms ({bnd[1]})",
                  flush=True)
            print("    device time by stage: "
                  + conv_stage_line(torch, kern, what), flush=True)
    cv.conv3x3_forward.launches, cv.conv3x3_backward.launches = saved
    return worst, times


# phase 14: bench.py's wide model (wide_model_row) through NeuralNet and
# Trainer at its full widths, batch and data: per layer (the fused families
# decline it by name), bf16, conv2 on the conv3x3 kernel.
WIDE_B, WIDE_IMG, WIDE_STEPS = 256, 56, 80
# The JAX package's eval-mode mean NLL of the first WIDE_B images at the
# initial weights, one forward on the CPU with THEANET_PALLAS_CONV=1
# (jax_cpu_reference.sh), held to these relative bounds
WIDE_NLL_JAX = {"bfloat16": 6.948939800262451, "float32": 6.948746204376221}
# (3.2e-6 and 6.9e-8 measured on an H100); a uniform output's NLL,
# ln 1000, is 6e-3 below
WIDE_NLL_RTOL = {"bfloat16": 1e-4, "float32": 1e-6}
# steps of the kernel's trajectory each retaken with the plain conv from the
# same state and generator. The costs agree within WIDE_LOCK_COST (7e-6
# measured on an H100: a rounding straddle in bf16 z moves an activation by
# an ulp). A step moves the weights by the OLD momentum, so this step's
# conv2 gradient shows in the new momentum m a + (1 - m) g: it agrees
# within one bf16 ulp of (1 - m) max|g| (dw is rounded to bf16 once).
WIDE_LOCK_STEPS = 5
WIDE_LOCK_COST = 2e-5


def wide_spec(dtype="bfloat16", img=WIDE_IMG, batch=WIDE_B, maps=(64, 128),
              n_hid=2048, n_out=1000, pdrop=0.5):
    """(layers, training_params) of bench.py's wide_model_row; the keywords
    give the tests narrower copies, and ``dtype`` None leaves COMPUTE_DTYPE
    unset."""
    layers = [
        ["InputLayer", {"img_sz": img}],
        ["ConvLayer", {"num_maps": maps[0], "filter_sz": 3, "stride": 1,
                       "actvn": "relu10"}],
        ["PoolLayer", {"pool_sz": 2}],
        ["ConvLayer", {"num_maps": maps[1], "filter_sz": 3, "stride": 1,
                       "actvn": "relu05"}],
        ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": n_hid, "pdrop": pdrop}],
        ["SoftmaxLayer", {"n_out": n_out}],
    ]
    tr = {"SEED": 7, "BATCH_SZ": batch, "NUM_EPOCHS": 1,
          "EPOCHS_TO_TEST": 1, "TEST_SAMP_SZ": batch,
          "INIT_LEARNING_RATE": 0.05, "EPOCHS_TO_HALF_RATE": 2}
    if dtype:
        tr["COMPUTE_DTYPE"] = dtype
    return layers, tr


def wide_data(n_batches=WIDE_STEPS):
    """bench.py's data: uniform images and labels in [0, 1000) from
    RandomState(0); its test set is the first batch."""
    import numpy as np

    rng = np.random.RandomState(0)
    n = n_batches * WIDE_B
    x = rng.rand(n, 1, WIDE_IMG, WIDE_IMG).astype(np.float32)
    y = rng.randint(0, 1000, n).astype(np.int32)
    return x, y


def wide_eval_nll(torch, net, params, x, y):
    """Eval-mode mean NLL of the head on a batch (dropout scaled)."""
    with torch.no_grad():
        hs = net.forward(params, x, train=False)
        return float(net.head.cost(hs, y))


@contextlib.contextmanager
def plain_conv():
    """Route ops.conv3x3's autograd function to the plain versions (on the
    card too) inside the block."""
    from theanet_tpu_torch.ops import conv3x3 as cv

    saved = cv.conv3x3_forward, cv.conv3x3_backward
    cv.conv3x3_forward = cv.conv3x3_forward_reference
    cv.conv3x3_backward = cv.conv3x3_backward_reference
    try:
        yield
    finally:
        cv.conv3x3_forward, cv.conv3x3_backward = saved


def phase14(torch, card, n_steps=WIDE_STEPS):
    from theanet_tpu_torch.model import NeuralNet
    from theanet_tpu_torch.ops import conv3x3 as cv
    from theanet_tpu_torch.trainer import Trainer, step_generator

    os.environ["THEANET_PALLAS_CONV"] = "1"
    x, y = wide_data(n_steps)
    layers, tr = wide_spec()
    net = NeuralNet(layers, tr)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        trainer = Trainer(net, x, y, x[:WIDE_B], y[:WIDE_B])
    print("  " + err.getvalue().strip(), flush=True)
    for part in ("per-layer path: the route rule: the JAX package's deep "
                 "VMEM model declines it", "the head does not fit shared "
                 "memory", "the flagship family declines it too"):
        assert part in err.getvalue(), err.getvalue()
    assert trainer._mega is None
    dev = trainer.device
    tx, ty = trainer.d_test_x, trainer.d_test_y

    # the initial eval NLL against the JAX package's CPU forward
    nll = {"bfloat16": wide_eval_nll(torch, net, trainer.params, tx, ty)}
    f32_net = NeuralNet(*wide_spec("float32"))
    nll["float32"] = wide_eval_nll(torch, f32_net,
                                   f32_net.init_params(dev)[0], tx, ty)
    for name, v in nll.items():
        ref = WIDE_NLL_JAX[name]
        print(f"  initial eval NLL of the first {WIDE_B} images, {name}: "
              f"{v:.6f} (JAX CPU {ref:.6f}, relative |d| "
              f"{abs(v - ref) / ref:.2e}, bound {WIDE_NLL_RTOL[name]})",
              flush=True)
        assert abs(v - ref) <= WIDE_NLL_RTOL[name] * abs(ref), (name, v)

    # the main path: 2 epochs, an eval after each, then the second epoch
    # again from a snapshot; the counts start at 0 here
    cv.conv3x3_forward.launches = cv.conv3x3_backward.launches = 0
    totals, evals = [], []
    t0 = time.time()
    for epoch in range(2):
        if epoch == 1:
            snap = trainer.snapshot_state()
        total, costs, _ = trainer.run_epoch()
        totals.append(costs)
        net.inc_epoch_set_rate()
        evals.append(trainer.evaluate_full("test"))
    trainer.restore_state(snap)
    _, replay, _ = trainer.run_epoch()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"conv3x3_forward": cv.conv3x3_forward.launches,
                "conv3x3_backward": cv.conv3x3_backward.launches}
    print(f"  wide model, {n_steps} steps x {WIDE_B} an epoch, bf16, per "
          f"layer: epoch costs {[float(c.sum()) for c in totals]}, first and "
          f"last step {float(totals[0][0]):.4f} {float(totals[1][-1]):.4f}; "
          f"test rows (err %, p(true) %) {evals}; replay of epoch 1 from "
          f"the snapshot {float(replay.sum()):.4f}, max|d| step cost "
          f"{float(abs(replay - totals[1]).max()):.3e} [{wall:.1f} s]",
          flush=True)
    print(f"  kernel launches in the main path: {launches} (3 epochs of "
          f"{n_steps} steps, 2 eval batches)", flush=True)
    assert launches == {"conv3x3_forward": 3 * n_steps + 2,
                        "conv3x3_backward": 3 * n_steps}, launches
    for c in totals + [replay]:
        assert all(math.isfinite(float(v)) for v in c)
    assert totals[1].sum() < totals[0].sum(), "the cost did not fall"
    assert (replay == totals[1]).all(), "the replay is not bit-equal"

    # step-locked: each step of the kernel's trajectory retaken with the
    # plain conv from the same state and generator
    p, m = trainer.params, trainer.moms
    lr = net.get_rate()
    mom = net.net_layers[3].reg["momentum"]
    worst_c = worst_m = 0.0
    for s in range(WIDE_LOCK_STEPS):
        ib = s % n_steps
        xs = trainer.d_train_x[ib * WIDE_B:(ib + 1) * WIDE_B]
        ys = trainer.d_train_y[ib * WIDE_B:(ib + 1) * WIDE_B]
        got = net.train_step(p, m, xs, ys, lr=lr,
                             generator=step_generator(7, s, dev))
        with plain_conv():
            ref = net.train_step(p, m, xs, ys, lr=lr,
                                 generator=step_generator(7, s, dev))
        d_c = abs(float(got[2]) - float(ref[2]))
        d_m = max_abs(got[1][3][0], ref[1][3][0])
        step_part = float((ref[1][3][0] - mom * m[3][0]).abs().max())
        lim = 2.0 ** -7 * step_part
        print(f"    step {s}: cost kernel {float(got[2]):.6f} plain "
              f"{float(ref[2]):.6f} (|d| {d_c:.2e}); conv2 momentum max|d| "
              f"{d_m:.3e}, bound {lim:.3e} ((1 - m) max|g| {step_part:.3e})",
              flush=True)
        assert d_c <= WIDE_LOCK_COST and d_m <= lim, (s, d_c, d_m, lim)
        assert step_part > 0
        worst_c, worst_m = max(worst_c, d_c), max(worst_m, d_m)
        p, m = got[0], got[1]

    # epoch times: the kernel and cuDNN (the switch off), in turns
    ms = {}
    for on in ("1", "0", "0", "1"):
        os.environ["THEANET_PALLAS_CONV"] = on
        ms.setdefault(on, []).append(timed(torch, trainer.run_epoch, 1))
    os.environ["THEANET_PALLAS_CONV"] = "0"
    profile_epoch(torch, lambda: [trainer._train_batch(i, i, lr)
                                  for i in range(10)], 10,
                  "10 per-layer wide steps, cuDNN conv2", top=4)
    os.environ["THEANET_PALLAS_CONV"] = "1"
    torch.cuda.reset_peak_memory_stats()
    profile_epoch(torch, lambda: [trainer._train_batch(i, i, lr)
                                  for i in range(10)], 10,
                  "10 per-layer wide steps, conv3x3 kernel", top=20)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  one wide epoch ({n_steps} steps x {WIDE_B}, bf16) on {card}: "
          f"conv3x3 kernel {ms['1']} ms, cuDNN (switch off) {ms['0']} ms; "
          f"peak memory of a step {peak:.2f} GiB", flush=True)
    cv.conv3x3_forward.launches = launches["conv3x3_forward"]
    cv.conv3x3_backward.launches = launches["conv3x3_backward"]
    bf16_fuses(torch)
    return launches, ms, (worst_c, worst_m)


def bf16_fuses(torch):
    """A bf16 mnist_cnn still fuses (bf16 is no disqualifier, as in the
    JAX package), and the flagship kernel computes it in f32: one epoch
    through the Trainer gives the f32 net's costs to the bit."""
    from theanet_tpu_torch.data import synth_hard
    from theanet_tpu_torch.model import NeuralNet
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.prms import fixdim, load_params
    from theanet_tpu_torch.trainer import Trainer

    saved = megastep.megastep_epoch.launches
    costs = {}
    for cd in ("float32", "bfloat16"):
        layers, tr, _ = load_params(os.path.join(REPO, "params",
                                                 "mnist_cnn.prms"))
        layers[0][1]["img_sz"] = 28
        tr.update(SEED=MAIN_SEED, COMPUTE_DTYPE=cd)
        trainer = Trainer(NeuralNet(layers, tr),
                          fixdim(synth_hard.training_x), synth_hard.training_y,
                          fixdim(synth_hard.testing_x), synth_hard.testing_y)
        assert trainer._mega_plan.epoch_fn is megastep.megastep_epoch
        costs[cd] = trainer.run_epoch()[1]
    megastep.megastep_epoch.launches = saved
    same = bool((costs["float32"] == costs["bfloat16"]).all())
    print(f"  mnist_cnn with COMPUTE_DTYPE bfloat16 fuses (flagship kernel):"
          f" epoch cost {float(costs['bfloat16'].sum()):.4f}, the float32 "
          f"net's {float(costs['float32'].sum()):.4f}, every step equal: "
          f"{same}", flush=True)
    assert same


# ----------------------------------------------------------- phases 15-16

# The data-parallel path (ops/megastep_dp.py): per step, each rank's
# gradient kernel on its shard, one all_reduce, the update kernel. Phase 15
# holds the two kernels to their plain versions at full width, (config,
# batch per rank), flat_mlp as the zero-level deep spec a mesh gives it.
DP_CASES = (("mnist_cnn", 20), ("mnist_cnn", 10), ("galaxy_rbf", 10),
            ("flat_mlp", 10))
# kernel vs plain version, one step: each gradient within DP_REL of its
# tensor's largest value, cost and minf within DP_REL of max(1, |value|)
# (both sum each output in one order; the dense products' f32 sums differ
# by a few ulps)
DP_REL = 1e-5
# phase 16: each run against the single-device fused Trainer at its SEED
# and words, 2 epochs, BATCH_SZ 20 (10 a rank at world 2). World 1 sums the
# same gradients in the same order: its step costs are held to
# DP_COST_RTOL (the JAX package's DP gate; measured 0). At world 2 the
# batch sums split in two, and SGD carries the last-ulp difference until
# the trajectory leaves that gate (measured on an H100: first at step 228
# of mnist_cnn's first epoch and step 27 of galaxy_rbf's, where pool ties
# amplify it): the two ranks are held instead to each other
# and to the in-process emulation of the two ranks, both to the bit, and
# the emulation to the epoch kernel step-locked (phase 15); the
# free-running costs are printed beside the single device's, and each
# epoch's total is held to DP_FREE_TOTAL_RTOL of it (measured up to 1.24%,
# galaxy_rbf's second epoch: a noise stream alone moves one SEED's costs
# by up to 25%, PERF.md).
DP_EPOCHS = 2
DP_COST_RTOL = 1e-4
DP_FREE_TOTAL_RTOL = 0.05


def dp_wrappers():
    """The per-step data-parallel path's four counted kernel wrappers."""
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_deep as deep

    return (megastep.megastep_grad_step, deep.deep_grad_step,
            megastep.megastep_update, deep.deep_update)


def ring_wrappers():
    """The whole-epoch ring's counted wrappers: its two epoch entries and
    the exchange (every exchange kernel that an epoch entry's C loop or
    ring_exchange launched)."""
    from theanet_tpu_torch.ops import megastep_ring as ring

    return (ring.megastep_ring_epoch, ring.deep_ring_epoch,
            ring.ring_exchange)


def dp_config(name):
    """(layers, training params, dataset module) of a config as its CLI run
    builds it: mnist_cnn.prms and the GEOM_CONFIGS with SEED MAIN_SEED, the
    others as CONFIGS pins them, NUM_EPOCHS DP_EPOCHS; the input layer sized
    to the data."""
    import ast
    import importlib

    from theanet_tpu_torch.prms import fixdim, load_params

    if name in GEOM_CONFIGS:
        layers, tr = geometry_config(name)
        tr["NUM_EPOCHS"] = DP_EPOCHS
        data_name = "synth_hard"
    elif name in ("mnist_cnn", "synth_aux"):
        layers, tr, _ = load_params(os.path.join(REPO, "params",
                                                 name + ".prms"))
        tr["NUM_EPOCHS"] = DP_EPOCHS
        if name == "mnist_cnn":
            tr["SEED"] = MAIN_SEED
        data_name = "synth_hard" if name == "mnist_cnn" else "synth_aux"
    else:
        prms = ast.literal_eval(config_text(name, epochs=DP_EPOCHS))
        layers = [[n, dict(a)] for n, a in prms["layers"]]
        tr = prms["training_params"]
        data_name = CONFIGS[name]["data"]
    data = importlib.import_module("theanet_tpu_torch.data." + data_name)
    shape = fixdim(data.training_x[:1]).shape
    layers[0][1]["img_sz"] = shape[3]
    if "num_maps" not in layers[0][1] and shape[1] != 1:
        layers[0][1]["num_maps"] = shape[1]
    return layers, tr, data


def dp_arrays(data):
    """A dataset's four arrays as the Trainer takes them."""
    from theanet_tpu_torch.prms import fixdim

    return (fixdim(data.training_x), data.training_y,
            fixdim(data.testing_x), data.testing_y)


def aux_arrays(data):
    """A dataset's aux arrays as the Trainer's keywords ({} without)."""
    if not hasattr(data, "training_aux"):
        return {}
    return dict(train_aux=data.training_aux, test_aux=data.testing_aux)


def dp_setup(torch, name, dev):
    """(net, global spec, initial state, natural x, y on the card) of a
    config matched as under a mesh (fused_plan(for_mesh=True))."""
    import numpy as np
    from theanet_tpu_torch.model import NeuralNet
    from theanet_tpu_torch.ops import megastep

    layers, tr, data = dp_config(name)
    net = NeuralNet(layers, tr)
    plan = megastep.fused_plan(net, for_mesh=True)
    assert plan is not None, megastep.fused_decline_reason(net)
    tx, ty, _, _ = dp_arrays(data)
    x = torch.as_tensor(tx, device=dev)
    y = torch.as_tensor(np.asarray(ty, np.int32), device=dev)
    return net, plan, initial_state(plan, net, dev), x, y


def dp_step_inputs(torch, spec, n, x, y, dev):
    """Rank 0's step-0 inputs on an n-rank mesh; the noise epoch is the
    first whose warp has no near-rounding pixel (as phase 2)."""
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_dp as dp

    for epoch in range(50):
        bits = megastep.epoch_noise_bits(7, epoch, spec, 1, dev)
        if not spec.nearest or near_rounding_pixels(
                torch, megastep, spec, bits, 0) == 0:
            break
    xs, ys = dp.dp_shard_data(spec, n, 0, x[:spec.batch], y[:spec.batch])
    ub, fb, pb, db = dp.dp_shard_words(spec, n, 0, bits)
    return xs[0], ys[0], (ub[0, 0], fb[0], pb[0], db[0])


def grad_step_flops(spec):
    """step_flops less the update's 10 operations a state element."""
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_deep as deep

    shapes = (megastep.kernel_shapes(spec)
              if isinstance(spec, megastep.MegaSpec)
              else deep.deep_kernel_shapes(spec))
    return step_flops(spec) - 10 * sum(r * c for r, c in shapes)


def phase15_case(torch, name, b_loc, dev, card, setup=None):
    """One gradient step and one update of a DP_CASES entry (or of
    ``setup``, dp_setup's tuple), kernel vs plain version, and their times.
    Returns {kernel: (largest absolute |d|, (ms, plain ms, bound))}."""
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_dp as dp

    net, plan, kp, x, y = setup or dp_setup(torch, name, dev)
    spec = plan.spec
    n = spec.batch // b_loc
    loc = dp.local_spec(spec, b_loc)
    xs, ys, words = dp_step_inputs(torch, spec, n, x, y, dev)
    shapes = [tuple(t.shape) for t in kp]
    ng = sum(t.numel() for t in kp)
    out = [(torch.empty(ng, device=dev), torch.empty(2, device=dev))
           for _ in range(2)]
    consts = dp.constants(loc, dev)
    dp.grad_step(loc, consts, xs, ys, words, kp, *out[0])
    dp.grad_step_reference(loc, consts, xs, ys, words, kp, *out[1])
    torch.cuda.synchronize()
    (g, cm), (g0, cm0) = out
    errs = [max_abs(a, b) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(megastep.split_grads(g, shapes),
                            megastep.split_grads(g0, shapes))]
    cm_err = max(abs(float(a) - float(b)) / max(1.0, abs(float(b)))
                 for a, b in zip(cm, cm0))
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    # the update from random momenta with the plain gradients
    gen = torch.Generator(device=dev).manual_seed(11)
    km = [0.01 * torch.randn(t.shape, generator=gen, device=dev) for t in kp]
    st = [([t.clone() for t in kp], [t.clone() for t in km])
          for _ in range(2)]
    dp.update(loc, *st[0], g0, 0.1)
    dp.update_reference(loc, *st[1], g0, 0.1)
    torch.cuda.synchronize()
    d_upd = max(max_abs(a, b) for a, b in zip(st[0][0] + st[0][1],
                                              st[1][0] + st[1][1]))
    moved = max(max_abs(a, b) for a, b in zip(st[0][0], kp))
    print(f"  {name} ({type(spec).__name__}, b_loc {b_loc}): gradient step "
          f"cost {float(cm[0]):.6f} (plain {float(cm0[0]):.6f}); largest "
          f"|d| / largest value: cost/minf {cm_err:.2e}, gradients "
          f"{max(errs):.2e} ({len(errs)} tensors); update max|d| "
          f"{d_upd:.2e} (params moved {moved:.2e})", flush=True)
    assert cm_err <= DP_REL and max(errs) <= DP_REL, (cm_err, errs)
    assert moved > 0 and d_upd <= STEP_ATOL, (moved, d_upd)

    grad_fn, upd_fn = dp.family(loc).grad_step, dp.family(loc).update
    saved = [fn.launches for fn in dp_wrappers()]
    p, m = st[0]
    ms_g = timed(torch, lambda: dp.grad_step(loc, consts, xs, ys, words, kp,
                                             g, cm), 100)
    ms_gp = timed(torch, lambda: dp.grad_step_reference(
        loc, consts, xs, ys, words, kp, g0, cm0), 5)
    ms_u = timed(torch, lambda: dp.update(loc, p, m, g0, 0.0), 100)
    ms_up = timed(torch, lambda: dp.update_reference(loc, p, m, g0, 0.0), 5)
    for fn, k in zip(dp_wrappers(), saved):   # timing launches do not count
        fn.launches = k
    b_grad = bound(nbytes(xs, ys, *words, *kp, g, cm), grad_step_flops(loc))
    b_upd = bound(nbytes(*kp, *km, g0, *kp, *km),
                  10 * sum(r * c for r, c in shapes))
    print(f"    on {card}: gradient step {ms_g:.4f} ms a call (plain "
          f"{ms_gp:.3f}; bound {b_grad[0]:.5f} ms, {b_grad[1]}), update "
          f"{ms_u:.4f} ms (plain {ms_up:.3f}; bound {b_upd[0]:.5f} ms, "
          f"{b_upd[1]})", flush=True)
    d_grad = max(max_abs(g, g0), max_abs(cm, cm0))
    return {grad_fn.__name__: (d_grad, (ms_g, ms_gp, b_grad)),
            upd_fn.__name__: (d_upd, (ms_u, ms_up, b_upd))}


def dp_locked_epoch(torch, name, mesh, dev):
    """One epoch of a config step-locked three ways from the data-parallel
    path's state: the world-1 DP step (grad_step, all_reduce over
    ``mesh``, update), the epoch kernel, the twin; and two emulated ranks
    (each shard's gradient kernel, their mean, the update) against the
    epoch kernel. Then the whole epoch free-running, DP against the epoch
    kernel. Returns the largest |d| of each comparison."""
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_dp as dp

    net, plan, kp, x, y = dp_setup(torch, name, dev)
    spec = plan.spec
    kernel, twin = family_fns(plan)
    xs, ys = dp.dp_shard_data(spec, 1, 0, x, y)
    nb = xs.shape[0]
    bits = megastep.epoch_noise_bits(3, 0, spec, nb, dev)
    epoch1 = dp.make_dp_epoch_fn(spec, 1, mesh)
    loc2 = dp.local_spec(spec, spec.batch // 2)
    shards = [dp.dp_shard_data(spec, 2, r, x, y) for r in range(2)]
    words2 = [dp.dp_shard_words(spec, 2, r, bits) for r in range(2)]
    ng = sum(t.numel() for t in kp)
    consts2 = dp.constants(loc2, dev)
    g2 = [torch.empty(ng, device=dev) for _ in range(2)]
    cm2 = torch.empty((2, 2), device=dev)
    p, m = kp, [torch.zeros_like(t) for t in kp]
    d_kernel = d_twin = d_twin_flip = d_ranks = 0.0
    t0 = time.time()
    for s in range(nb):
        sl = slice(s, s + 1)
        b_s = tuple(b[sl] for b in bits)
        got = epoch1(p, m, xs[sl], ys[sl], b_s, 0.1)
        ker = kernel(p, m, xs[sl], ys[sl], b_s, 0.1, spec)
        ref = twin(p, m, xs[sl], ys[sl], b_s, 0.1, spec)
        p2, m2 = [t.clone() for t in p], [t.clone() for t in m]
        for r in range(2):
            ub, fb, pb, db = words2[r]
            dp.grad_step(loc2, consts2, shards[r][0][s], shards[r][1][s],
                         (ub[s, 0], fb[s], pb[s], db[s]), p, g2[r], cm2[r])
        dp.update(loc2, p2, m2, (g2[0] + g2[1]) / 2, 0.1)
        d_kernel = max(d_kernel, max(max_abs(a, b) for a, b in zip(
            got[0] + got[1] + [got[2]], ker[0] + ker[1] + [ker[2]])))
        d = max(max_abs(a, b) for a, b in zip(got[0] + got[1] + [got[2]],
                                              ref[0] + ref[1] + [ref[2]]))
        if spec.nearest and near_rounding_pixels(torch, megastep, spec, b_s,
                                                 0):
            d_twin_flip = max(d_twin_flip, d)
        else:
            d_twin = max(d_twin, d)
            d_ranks = max(d_ranks, max(max_abs(a, b) for a, b in zip(
                p2 + m2, ker[0] + ker[1])))
        p, m = got[0], got[1]
    epoch_dp = dp.make_dp_epoch_fn(spec, nb, mesh)
    free_dp = epoch_dp(kp, [torch.zeros_like(t) for t in kp], xs, ys, bits,
                       0.1)
    free_k = kernel(kp, [torch.zeros_like(t) for t in kp], xs, ys, bits,
                    0.1, spec)
    d_free = max(max_abs(a, b) for a, b in zip(
        free_dp[0] + free_dp[1] + [free_dp[2]],
        free_k[0] + free_k[1] + [free_k[2]]))
    print(f"  {name}, {nb} steps step-locked: max|d| DP world 1 vs epoch "
          f"kernel {d_kernel:.3e}, vs twin {d_twin:.3e} ({d_twin_flip:.3e} "
          f"on steps with a near-rounding pixel); 2 emulated ranks vs epoch "
          f"kernel {d_ranks:.3e}; free-running epoch, DP vs epoch kernel "
          f"{d_free:.3e} [{time.time() - t0:.1f} s]", flush=True)
    assert d_twin <= STEP_ATOL and d_twin_flip <= FLIP_ATOL, (d_twin,
                                                              d_twin_flip)
    assert d_ranks <= STEP_ATOL, d_ranks
    return d_kernel, d_twin, d_ranks, d_free


def phase15(torch, dev, card, mesh):
    """Returns ({kernel: (largest |d|, times)} at the world-2 runs' shapes,
    mnist_cnn's and galaxy_rbf's at 10 a rank, and the step-locked
    epochs' differences)."""
    kernels = {}
    for name, b_loc in DP_CASES:
        out = phase15_case(torch, name, b_loc, dev, card)
        if b_loc == 10 and name != "flat_mlp":
            kernels.update(out)
    locked = {name: dp_locked_epoch(torch, name, mesh, dev)
              for name in ("mnist_cnn", "galaxy_rbf")}
    return kernels, locked


def single_device_run(torch, name, epochs=DP_EPOCHS):
    """The single-device fused Trainer of a config: (costs per epoch, ms per
    epoch by CUDA events)."""
    from theanet_tpu_torch.model import NeuralNet
    from theanet_tpu_torch.trainer import Trainer

    layers, tr, data = dp_config(name)
    net = NeuralNet(layers, tr)
    trainer = Trainer(net, *dp_arrays(data), **aux_arrays(data))
    costs, ms = [], []
    for _ in range(epochs):
        ms.append(timed_once(torch, lambda: costs.append(
            trainer.run_epoch()[1])))
        net.inc_epoch_set_rate()
    return costs, ms


def timed_once(torch, fn):
    """ms of one call by CUDA events (no warm-up: a training epoch moves
    the state)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def cost_gap(costs, ref):
    """(largest relative step-cost difference, first (epoch, step) beyond
    DP_COST_RTOL or None)."""
    import numpy as np

    worst, first = 0.0, None
    for e, (c, r) in enumerate(zip(costs, ref)):
        rel = np.abs(np.asarray(c) - r) / np.maximum(np.abs(r), 1e-12)
        worst = max(worst, float(rel.max()))
        over = np.nonzero(rel > DP_COST_RTOL)[0]
        if first is None and over.size:
            first = (e, int(over[0]))
    return worst, first


def emulated_ranks(torch, name, n, dev):
    """The n-rank data-parallel run of a config in this one process: each
    step every rank's gradient kernel on its shard, the sum over ranks
    divided by n (what all_reduce and div_ compute: for two ranks one
    commutative f32 add), the update kernel; cost summed over ranks / n and
    minf their min, at the Trainer's noise words and learning rates.
    Returns (step costs per epoch, final owned-layer weights as numpy)."""
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_dp as dp

    net, plan, kp, x, y = dp_setup(torch, name, dev)
    spec = plan.spec
    loc = dp.local_spec(spec, spec.batch // n)
    shards = [dp.dp_shard_data(spec, n, r, x, y) for r in range(n)]
    nb = shards[0][0].shape[0]
    p, m = [t.clone() for t in kp], [torch.zeros_like(t) for t in kp]
    ng = sum(t.numel() for t in kp)
    g = [torch.empty(ng, device=dev) for _ in range(n)]
    cmr = torch.empty((n, 2), device=dev)
    consts = dp.constants(loc, dev)
    costs = []
    for _ in range(DP_EPOCHS):
        bits = megastep.epoch_noise_bits(net.tr_prms["SEED"], net.get_epoch(),
                                         spec, nb, dev)
        words = [dp.dp_shard_words(spec, n, r, bits) for r in range(n)]
        lr = net.get_rate()
        cost = torch.empty(nb, device=dev)
        for s in range(nb):
            for r in range(n):
                ub, fb, pb, db = words[r]
                dp.grad_step(loc, consts, shards[r][0][s], shards[r][1][s],
                             (ub[s, 0], fb[s], pb[s], db[s]), p, g[r],
                             cmr[r])
            tot = g[0].clone()
            for r in range(1, n):
                tot += g[r]
            dp.update(loc, p, m, tot.div_(n), lr)
            c = cmr[0, 0].clone()
            for r in range(1, n):
                c += cmr[r, 0]
            cost[s] = c / n
        costs.append(cost.cpu().numpy())
        net.inc_epoch_set_rate()
    return costs, [[w.cpu().numpy() for w in lw]
                   for lw in plan.framework_layout(p, spec)], plan.layer_idx


def phase16(torch, card, mesh):
    from theanet_tpu_torch.model import NeuralNet
    from theanet_tpu_torch.parallel import launch
    from theanet_tpu_torch.parallel.launch import train_ranks
    from theanet_tpu_torch.trainer import Trainer

    launches = {fn.__name__: 0 for fn in dp_wrappers()}
    report = {}
    # world 1, NCCL, this process; THEANET_DP_RING=0 keeps the per-step
    # path (phase 18 drives the ring)
    ref_costs, ref_ms = single_device_run(torch, "mnist_cnn")
    layers, tr, data = dp_config("mnist_cnn")
    net = NeuralNet(layers, tr)
    os.environ["THEANET_DP_RING"] = "0"
    try:
        trainer = Trainer(net, *dp_arrays(data), mesh=mesh)
    finally:
        os.environ["THEANET_DP_RING"] = "auto"
    nb = trainer.n_train_batches
    for fn in dp_wrappers():
        fn.launches = 0
    costs, ms = [], []
    for _ in range(DP_EPOCHS):
        ms.append(timed_once(torch, lambda: costs.append(
            trainer.run_epoch()[1])))
        net.inc_epoch_set_rate()
    counts = {fn.__name__: fn.launches for fn in dp_wrappers()}
    gap, first = cost_gap(costs, ref_costs)
    print(f"  mnist_cnn, world 1 (NCCL), {DP_EPOCHS} epochs of {nb} steps: "
          f"epoch ms {[round(t, 3) for t in ms]} (single-device epoch "
          f"kernel {[round(t, 3) for t in ref_ms]}); step costs vs single "
          f"device: largest relative |d| {gap:.3e}; launches {counts}",
          flush=True)
    assert first is None, first
    assert counts == {"megastep_grad_step": DP_EPOCHS * nb,
                      "megastep_update": DP_EPOCHS * nb, "deep_grad_step": 0,
                      "deep_update": 0}, counts
    for k, v in counts.items():
        launches[k] += v
    idle = profile_epoch(torch, trainer.run_epoch, nb,
                         "one mnist_cnn DP epoch at world 1", top=8)
    report["mnist_cnn world 1"] = (ms, ref_ms, idle)

    # world 2, gloo: two processes share the card
    names = ("mnist_cnn", "galaxy_rbf", "flat_mlp")
    with tempfile.TemporaryDirectory() as tmp:
        job = []
        for name in names:
            layers, tr, data = dp_config(name)
            job.append(dict(name=name, layers=layers, training_params=tr,
                            data=dp_arrays(data), epochs=DP_EPOCHS,
                            profile=True, dp_ring="0"))
        job_file = os.path.join(tmp, "job.pkl")
        with open(job_file, "wb") as f:
            pickle.dump(job, f)
        t0 = time.time()
        launch(train_ranks, 2, "gloo", os.path.join(tmp, "rendezvous"),
               job_file, tmp, timeout=900)
        print(f"  world 2 (gloo, 2 processes on the card): "
              f"{time.time() - t0:.1f} s for the three runs", flush=True)
        ranks = {}
        for name in names:
            ranks[name] = []
            for r in range(2):
                with open(os.path.join(tmp, f"{name}_rank{r}.pkl"),
                          "rb") as f:
                    ranks[name].append(pickle.load(f))
    for name in names:
        ref_costs, ref_ms = single_device_run(torch, name)
        emu_costs, emu_params, idx = emulated_ranks(torch, name, 2,
                                                    mesh.device)
        for fn, k in zip(dp_wrappers(), [launches[fn.__name__]
                                          for fn in dp_wrappers()]):
            fn.launches = k   # the emulation's launches do not count
        r0, r1 = ranks[name]
        nb = len(ref_costs[0])
        family = "megastep" if name == "mnist_cnn" else "deep"
        want = {fn.__name__: 0 for fn in dp_wrappers() + ring_wrappers()}
        want[family + "_grad_step"] = want[family + "_update"] = (
            DP_EPOCHS * nb)
        same = all((a == b).all() for la, lb in zip(r0["params"],
                                                   r1["params"])
                   for a, b in zip(la, lb))
        as_emulated = (all((a == b).all() for a, b in zip(r0["costs"],
                                                          emu_costs))
                       and all((a == b).all() for i, lb in zip(idx,
                                                               emu_params)
                               for a, b in zip(r0["params"][i], lb)))
        gap, first = cost_gap(r0["costs"], ref_costs)
        print(f"  {name}, world 2, {DP_EPOCHS} epochs of {nb} steps (10 a "
              f"rank): epoch ms rank 0 {[round(t, 3) for t in r0['ms']]}, "
              f"rank 1 {[round(t, 3) for t in r1['ms']]} (single-device "
              f"epoch kernel {[round(t, 3) for t in ref_ms]}); device idle "
              f"share rank 0 {100 * r0['idle_share']:.1f}%, rank 1 "
              f"{100 * r1['idle_share']:.1f}%; step costs vs single device: "
              f"largest relative |d| {gap:.3e}, first beyond "
              f"{DP_COST_RTOL:g} at (epoch, step) {first}; epoch totals "
              f"{[round(float(c.sum()), 4) for c in r0['costs']]} (single "
              f"device {[round(float(c.sum()), 4) for c in ref_costs]}); "
              f"ranks' params bit-identical: {same}; costs and params "
              f"bit-equal to the in-process emulation of the two ranks: "
              f"{as_emulated}; launches rank 0 {r0['launches']}, rank 1 "
              f"{r1['launches']}", flush=True)
        assert same and as_emulated
        assert r0["launches"] == want and r1["launches"] == want, (
            r0["launches"], r1["launches"], want)
        assert [r["wrote_checkpoint"] for r in (r0, r1)] == [True, False]
        for c, ref in zip(r0["costs"], ref_costs):
            assert abs(float(c.sum()) - float(ref.sum())) <= (
                DP_FREE_TOTAL_RTOL * abs(float(ref.sum()))), (c.sum(),
                                                             ref.sum())
        for k in launches:
            launches[k] += r0["launches"][k] + r1["launches"][k]
        report[name + " world 2"] = (r0["ms"], ref_ms)
    print(f"kernel launches in the main path: {launches}", flush=True)
    return launches, report

# ---------------------------------------------------------- phases 17-18
# The whole-epoch ring (ops/megastep_ring.py; megastep_ring_epoch,
# deep_ring_epoch and the exchange of csrc/ring.cuh). Phase 17 holds the
# exchange kernel to exchange_reference over n buffers of this process in
# each mode: (mode, ranks, THEANET_RING_RS). Both add in one order and
# multiply once, so they agree to the bit.
RING_CASES = (("gather", 2, "0"), ("reduce-scatter", 2, "1"),
              ("reduce-scatter", 3, "auto"), ("reduce-scatter", 4, "auto"))
# the ring epoch entries at 2 ranks in this process against the plain
# version, step-locked: (config, THEANET_RING_RS), RING_LOCKED_STEPS steps
RING_LOCKED = (("mnist_cnn", "0"), ("mnist_cnn", "1"), ("galaxy_rbf", "0"))
RING_LOCKED_STEPS = 4
# the flagship heads above the old 48 KB of shared memory (50,400 and
# 86,016 bytes), each against its twin step-locked, RING_HEAD_STEPS steps
RING_HEADS = (600, 1024)
RING_HEAD_STEPS = 3
# phase 18's real ranks on the one card (gloo; the ring maps the ranks'
# buffers through CUDA IPC): (run name, config, THEANET_RING_RS)
RING_WORLD2 = (("mnist_cnn", "mnist_cnn", "auto"),
               ("galaxy_rbf", "galaxy_rbf", "auto"),
               ("flat_mlp", "flat_mlp", "auto"),
               ("mnist_cnn-rs", "mnist_cnn", "1"))
RING_WORLD4 = (("mnist_cnn-4", "mnist_cnn", "auto"),)
RING_WORLD4_EPOCHS = 1
# exchange kernels a step (csrc/ring.cuh ring_phase): publish + gather, or
# publish + reduce-scatter + publish + all-gather
RING_EXCHANGES = {False: 2, True: 4}


def ring_lib(spec):
    from theanet_tpu_torch.ops import megastep

    return "megastep" if isinstance(spec, megastep.MegaSpec) else \
        "megastep_deep"


def rs_of(n, rs_env):
    """use_rs(n) under THEANET_RING_RS=rs_env."""
    from theanet_tpu_torch.ops import megastep_ring as ring

    os.environ["THEANET_RING_RS"] = rs_env
    try:
        return ring.use_rs(n)
    finally:
        os.environ["THEANET_RING_RS"] = "auto"


class LocalRing:
    """n ranks' exchange buffers, IPC events and shared host counters in
    this one process: the ring tables of the in-process emulations
    (``tables(step0)``, rank by rank). ``close`` destroys the events."""

    def __init__(self, torch, lib, n, ng, rs, chunks, dev):
        import ctypes

        from theanet_tpu_torch.ops import _build
        from theanet_tpu_torch.ops import megastep_ring as ring

        self.lib, self.n, self.rs, self.chunks, self.dev = (lib, n, rs,
                                                            chunks, dev)
        self.bufs = [torch.zeros(_build.ring_buffer_bytes(lib, ng) // 4,
                                 device=dev) for _ in range(n)]
        self.events = [_build.ring_events_alloc(lib, dev)[0]
                       for _ in range(n)]
        self.host = ctypes.create_string_buffer(128 * ring.MAX_RANKS)
        self.host_ptr = ctypes.addressof(self.host)

    def tables(self, step0):
        from theanet_tpu_torch.ops import megastep_ring as ring

        return [ring.ring_table(self.n, r, self.rs, step0,
                                [b.data_ptr() for b in self.bufs],
                                self.chunks, wait_s=10.0, events=self.events,
                                host=self.host_ptr) for r in range(self.n)]

    def close(self):
        from theanet_tpu_torch.ops import _build

        for ev in self.events:
            _build.ring_events_free(self.lib, ev, self.dev)


def exchange_case(torch, name, n, rs_env, dev):
    """The exchange kernel against exchange_reference at a config's state
    (two steps, both slot parities): every rank's reduced gradient and
    (cost, minf), bit for bit. Returns (largest |d|, the LocalRing, its
    tables, the chunks, the mode, the gradient count, the last step's
    gradients and stats, for timing; the caller closes the LocalRing)."""
    from theanet_tpu_torch.ops import megastep_dp as dp
    from theanet_tpu_torch.ops import megastep_ring as ring

    _, plan, _, _, _ = dp_setup(torch, name, dev)
    spec = plan.spec
    shapes = dp.family(spec).shapes(spec)
    ng = sum(r * c for r, c in shapes)
    rs = rs_of(n, rs_env)
    chunks = (ring.flat_chunks(shapes, ring.owner_groups(shapes, n)) if rs
              else None)
    local = LocalRing(torch, ring_lib(spec), n, ng, rs, chunks, dev)
    bufs, tables = local.bufs, local.tables(0)
    gen = torch.Generator(device=dev).manual_seed(17 + n)
    worst = 0.0
    for step in (5, 6):
        gs, cms = [], []
        for r in range(n):
            scale = torch.exp2(torch.randint(-12, 6, (ng,), generator=gen,
                                             device=dev).float())
            gs.append(torch.randn(ng, generator=gen, device=dev) * scale)
            cms.append(torch.rand(2, generator=gen, device=dev) * 3)
            st, slot = ring.buffer_views(bufs[r], ng, step)
            st.copy_(cms[r])
            slot.copy_(gs[r])
        outs = [torch.full((ng,), float("nan"), device=dev) for _ in range(n)]
        cmo = [torch.full((2,), float("nan"), device=dev) for _ in range(n)]
        for phase in (1, 2, 3):
            for r in range(n):
                ring.ring_exchange(local.lib, tables[r], ng, step, phase,
                                   outs[r], cmo[r])
        torch.cuda.synchronize()
        ref, rcm = ring.exchange_reference(gs, cms, rs, chunks)
        for r in range(n):
            worst = max(worst, max_abs(outs[r], ref), max_abs(cmo[r], rcm))
            assert torch.equal(outs[r], ref) and torch.equal(cmo[r], rcm), (
                name, n, rs, r, max_abs(outs[r], ref))
    return worst, (local, tables, chunks, rs, ng, gs, cms)


def phase17_heads(torch, dev, data_mod):
    """mnist_cnn at BATCH_SZ 600 and 1024 fuses (beyond 48 KB of the former
    one-block head's scratch) and the flagship kernel follows its twin
    step-locked.
    Returns the largest |d| on steps without a near-rounding pixel."""
    from theanet_tpu_torch.model import NeuralNet
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.prms import load_params

    worst = 0.0
    saved = megastep.megastep_epoch.launches
    for batch in RING_HEADS:
        layers, tr, _ = load_params(os.path.join(REPO, "params",
                                                 "mnist_cnn.prms"))
        layers[0][1]["img_sz"] = 28
        tr.update(SEED=1, BATCH_SZ=batch, MEGAFUSED=True)
        net = NeuralNet(layers, tr)
        plan = megastep.fused_plan(net)
        assert plan is not None and plan.epoch_fn is megastep.megastep_epoch
        spec = plan.spec
        head = megastep.flagship_head_smem(spec)
        assert head > 48 * 1024, head
        nb = RING_HEAD_STEPS
        x = torch.as_tensor(data_mod.training_x[:nb * batch],
                            device=dev).reshape(nb, batch, spec.hw)
        y = torch.as_tensor(data_mod.training_y[:nb * batch],
                            device=dev).reshape(nb, batch)
        kp = initial_state(plan, net, dev)
        km = [torch.zeros_like(t) for t in kp]
        bits = megastep.epoch_noise_bits(3, 0, spec, nb, dev)
        clean, flip, n_near, (p1, _) = step_locked(torch, megastep, spec, kp,
                                                   km, x, y, bits)
        moved = max(max_abs(a, b) for a, b in zip(p1, kp))
        print(f"  mnist_cnn at BATCH_SZ {batch} (route-rule head "
              f"threshold {head:,} bytes): fuses; {nb} steps step-locked, "
              f"kernel vs "
              f"twin max|d| {clean:.3e} ({n_near} steps with a near-rounding "
              f"pixel: {flip:.3e}); params moved {moved:.3e}", flush=True)
        assert moved > 0 and clean <= STEP_ATOL and flip <= FLIP_ATOL, (
            clean, flip)
        worst = max(worst, clean)
    megastep.megastep_epoch.launches = saved
    return worst


def ring_locked(torch, name, rs_env, dev):
    """The ring epoch entry of a config (megastep_ring_epoch or
    deep_ring_epoch) at 2 ranks in this process, one thread and one stream
    a rank over a LocalRing, one step a call, against
    ring_epoch_reference's plain version (plain gradient step, plain
    exchange, plain update) from the same state, RING_LOCKED_STEPS steps;
    each step starts from the kernel's state. The two ranks must agree to
    the bit. Returns the largest |d| of the state, costs and minf on steps
    without a near-rounding pixel (held to STEP_ATOL) and on steps with
    one (FLIP_ATOL)."""
    from concurrent.futures import ThreadPoolExecutor

    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_dp as dp
    from theanet_tpu_torch.ops import megastep_ring as ring

    n, nb = 2, RING_LOCKED_STEPS
    _, plan, kp, x, y = dp_setup(torch, name, dev)
    spec = plan.spec
    loc = dp.local_spec(spec, spec.batch // n)
    shapes = dp.family(loc).shapes(loc)
    ng = sum(r * c for r, c in shapes)
    rs = rs_of(n, rs_env)
    chunks = (ring.flat_chunks(shapes, ring.owner_groups(shapes, n)) if rs
              else None)
    kernel = (ring.megastep_ring_epoch if isinstance(spec, megastep.MegaSpec)
              else ring.deep_ring_epoch)
    shards = [dp.dp_shard_data(spec, n, r, x, y) for r in range(n)]
    bits = megastep.epoch_noise_bits(3, 0, spec, shards[0][0].shape[0], dev)
    words = [dp.dp_shard_words(spec, n, r, bits) for r in range(n)]
    local = LocalRing(torch, ring_lib(spec), n, ng, rs, chunks, dev)
    streams = [torch.cuda.Stream(dev) for _ in range(n)]
    p, m = kp, [torch.zeros_like(t) for t in kp]
    worst = worst_flip = 0.0

    def rank_step(r, s, table):
        with torch.cuda.stream(streams[r]):
            out = kernel(p, m, shards[r][0][s:s + 1], shards[r][1][s:s + 1],
                         tuple(w[s:s + 1] for w in words[r]), 0.1, loc,
                         table)
        streams[r].synchronize()
        return out

    try:
        with ThreadPoolExecutor(n) as pool:
            for s in range(nb):
                tables = local.tables(s)
                torch.cuda.synchronize()
                got = list(pool.map(rank_step, range(n), [s] * n, tables))
                b_s = tuple(b[s:s + 1] for b in bits)
                ref = ring.ring_epoch_reference(
                    spec, n, [(xs[s:s + 1], ys[s:s + 1]) for xs, ys in shards],
                    p, m, b_s, 0.1, rs)
                a, b = got[0][0] + got[0][1] + [got[0][2]], got[1][0] + \
                    got[1][1] + [got[1][2]]
                assert all(torch.equal(u, v) for u, v in zip(a, b)), (name, s)
                d = max(max_abs(u, v) for u, v in zip(
                    a, ref[0] + ref[1] + [ref[2]]))
                if spec.nearest and near_rounding_pixels(torch, megastep,
                                                         spec, b_s, 0):
                    worst_flip = max(worst_flip, d)
                else:
                    worst = max(worst, d)
                p, m = got[0][0], got[0][1]
    finally:
        local.close()
    moved = max(max_abs(u, v) for u, v in zip(p, kp))
    print(f"  {name}, {kernel.__name__} at 2 ranks in this process "
          f"({'reduce-scatter' if rs else 'gather'}), {nb} steps step-locked "
          f"against ring_epoch_reference's plain version: ranks bit-equal; "
          f"max|d| {worst:.3e} (steps with a near-rounding pixel: "
          f"{worst_flip:.3e}); params moved {moved:.3e}", flush=True)
    assert moved > 0 and worst <= STEP_ATOL and worst_flip <= FLIP_ATOL, (
        worst, worst_flip)
    return worst


def phase17(torch, dev, card):
    """Returns (largest |d| of the exchange, (ms, plain ms, bound, library
    ms) of one gather exchange at mnist_cnn's state, 2 ranks, the largest
    |d| of the heads, {ring epoch entry: largest |d| against the plain
    version})."""
    import torch.distributed as dist
    from theanet_tpu_torch.data import synth_hard
    from theanet_tpu_torch.ops import megastep_ring as ring

    saved = [fn.launches for fn in ring_wrappers()]
    worst, timing = 0.0, None
    for name in ("mnist_cnn", "galaxy_rbf"):
        for mode, n, rs_env in RING_CASES:
            d, kit = exchange_case(torch, name, n, rs_env, dev)
            print(f"  {name}, {mode} at {n} ranks (THEANET_RING_RS="
                  f"{rs_env}): exchange kernel vs exchange_reference, 2 "
                  f"steps, every rank: max|d| {d:.3e} ({kit[4]:,} "
                  f"gradient floats" + (f", {len(kit[2])} chunks"
                                        if kit[2] else "") + ")", flush=True)
            worst = max(worst, d)
            if name == "mnist_cnn" and mode == "gather":
                timing = kit
            else:
                kit[0].close()
    local, tables, chunks, rs, ng, gs, cms = timing
    out = torch.empty(ng, device=dev)
    cm = torch.empty(2, device=dev)
    ms = timed(torch, lambda: ring.ring_exchange(local.lib, tables[0], ng, 6,
                                                 3, out, cm), 200)
    ms_plain = timed(torch, lambda: ring.exchange_reference(gs, cms, rs,
                                                            chunks), 50)
    flat = gs[0].clone()
    ms_lib = timed(torch, lambda: dist.all_reduce(flat), 200)
    local.close()
    bnd = bound(nbytes(*gs, out) + 4 * 2 * 3, 2 * ng)
    print(f"    on {card}: one gather exchange (2 ranks, mnist_cnn's "
          f"{ng:,} floats) {1e3 * ms:.2f} us a call (plain "
          f"{1e3 * ms_plain:.2f} us; bound {1e3 * bnd[0]:.3f} us, {bnd[1]}); "
          f"dist.all_reduce of the same buffer at world 1 on NCCL "
          f"{1e3 * ms_lib:.2f} us", flush=True)
    locked = {}
    for name, rs_env in RING_LOCKED:
        d = ring_locked(torch, name, rs_env, dev)
        entry = ("megastep_ring_epoch" if name == "mnist_cnn"
                 else "deep_ring_epoch")
        locked[entry] = max(locked.get(entry, 0.0), d)
    for fn, k in zip(ring_wrappers(), saved):   # the checks do not count
        fn.launches = k
    d_heads = phase17_heads(torch, dev, synth_hard)
    return worst, (ms, ms_plain, bnd, ms_lib), d_heads, locked


def ring_emulation(torch, name, n, rs, epochs):
    """The n-rank ring run of a config in this one process,
    ring_epoch_reference on the card with the kernels' own gradient and
    update stages (plain=False): what the real ranks must equal to the
    bit. Returns (step costs per epoch, owned-layer weights, layer
    indices)."""
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_dp as dp
    from theanet_tpu_torch.ops import megastep_ring as ring

    dev = torch.device("cuda")
    net, plan, kp, x, y = dp_setup(torch, name, dev)
    spec = plan.spec
    shards = [dp.dp_shard_data(spec, n, r, x, y) for r in range(n)]
    aux = aux_arrays(dp_config(name)[2]).get("train_aux")
    aux_shards = None if aux is None else [
        dp.dp_shard_aux(spec, n, r, torch.as_tensor(aux, device=dev))
        for r in range(n)]
    nb = shards[0][0].shape[0]
    p, m = kp, [torch.zeros_like(t) for t in kp]
    saved = [fn.launches for fn in dp_wrappers()]
    costs = []
    for _ in range(epochs):
        bits = megastep.epoch_noise_bits(net.tr_prms["SEED"], net.get_epoch(),
                                         spec, nb, dev)
        p, m, cm = ring.ring_epoch_reference(spec, n, shards, p, m, bits,
                                             net.get_rate(), rs, plain=False,
                                             aux_shards=aux_shards)
        costs.append(cm[:, 0].cpu().numpy())
        net.inc_epoch_set_rate()
    for fn, k in zip(dp_wrappers(), saved):   # the emulation's launches
        fn.launches = k
    return costs, [[w.cpu().numpy() for w in lw]
                   for lw in plan.framework_layout(p, spec)], plan.layer_idx


def ring_world1(torch, name, mesh, card):
    """A config at world 1 in this process: the mesh Trainer must take the
    ring under 'auto' and equal the single-device epoch kernel's Trainer to
    the bit over DP_EPOCHS epochs. Returns (ring ms per epoch, single ms
    per epoch, idle share of a ring epoch, largest |d|, plain ms of one
    emulated epoch at n = 1, bound)."""
    from theanet_tpu_torch.model import NeuralNet
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_dp as dp
    from theanet_tpu_torch.ops import megastep_ring as ring
    from theanet_tpu_torch.trainer import Trainer

    out = {}
    for kind in ("single", "ring"):
        layers, tr, data = dp_config(name)
        net = NeuralNet(layers, tr)
        trainer = Trainer(net, *dp_arrays(data),
                          mesh=mesh if kind == "ring" else None)
        if kind == "ring":
            assert getattr(trainer._mega_epoch, "ring", False)
        costs, ms = [], []
        for _ in range(DP_EPOCHS):
            ms.append(timed_once(torch, lambda: costs.append(
                trainer.run_epoch()[1])))
            net.inc_epoch_set_rate()
        out[kind] = (costs, ms, trainer, net)
    (c1, ms1, t1, _), (c2, ms2, t2, net) = out["single"], out["ring"]
    d = max(max(float(abs(a - b).max()) for a, b in zip(c1, c2)),
            max(max_abs(a, b) for a, b in zip(t1._kp + t1._km,
                                              t2._kp + t2._km)))
    nb = t2.n_train_batches
    saved = [fn.launches for fn in ring_wrappers()]
    idle = profile_epoch(torch, t2.run_epoch, nb,
                         f"one {name} ring epoch at world 1", top=6)
    spec = t2._mega_spec
    bits = megastep.epoch_noise_bits(net.tr_prms["SEED"], 0, spec, nb,
                                     mesh.device)
    shards = [(t2._mega_x, t2._mega_y)]
    kp, km = t2._kp, t2._km
    saved_dp = [fn.launches for fn in dp_wrappers()]
    ms_plain = timed_once(torch, lambda: ring.ring_epoch_reference(
        spec, 1, shards, kp, km, bits, 0.1, False))
    for fn, k in zip(dp_wrappers() + ring_wrappers(), saved_dp + saved):
        fn.launches = k   # the profile and plain epochs do not count
    bnd = epoch_bound(spec, [t2._mega_x, t2._mega_y, *bits, *kp, *km],
                      [*kp, *km, torch.empty((nb, 2))], nb)
    t1.close()
    t2.close()
    print(f"  {name}, world 1 (this process, THEANET_DP_RING=auto: the "
          f"ring), {DP_EPOCHS} epochs of {nb} steps on {card}: ring epoch "
          f"ms {[round(t, 3) for t in ms2]} (single-device epoch kernel "
          f"{[round(t, 3) for t in ms1]}); costs and state vs the epoch "
          f"kernel max|d| {d:.3e}; idle share {100 * idle:.1f}%; plain "
          f"emulated epoch {ms_plain:.1f} ms", flush=True)
    assert d == 0.0, d
    return ms2, ms1, idle, d, ms_plain, bnd


def ring_ranks(torch, n, runs, epochs, tmp):
    """Start n ranks on the card (gloo; the ring maps their buffers through
    CUDA IPC), each training ``runs`` (name, config, THEANET_RING_RS) for
    ``epochs`` epochs with THEANET_DP_RING=1.
    Returns {name: [rank outputs]} and the wall seconds."""
    from theanet_tpu_torch.parallel import launch
    from theanet_tpu_torch.parallel.launch import train_ranks

    job = []
    for name, cfg, rs_env in runs:
        layers, tr, data = dp_config(cfg)
        job.append(dict(name=name, layers=layers, training_params=tr,
                        data=dp_arrays(data) + tuple(
                            aux_arrays(data).values()),
                        epochs=epochs, profile=True, dp_ring="1",
                        ring_rs=rs_env))
    job_file = os.path.join(tmp, f"job{n}.pkl")
    with open(job_file, "wb") as f:
        pickle.dump(job, f)
    t0 = time.time()
    launch(train_ranks, n, "gloo", os.path.join(tmp, f"rendezvous{n}"),
           job_file, tmp, timeout=900)
    wall = time.time() - t0
    out = {}
    for name, _, _ in runs:
        out[name] = []
        for r in range(n):
            with open(os.path.join(tmp, f"{name}_rank{r}.pkl"), "rb") as f:
                out[name].append(pickle.load(f))
    return out, wall


def check_ring_run(torch, name, cfg, rs_env, n, ranks, epochs, cache):
    """The real ranks of one run against each other, the emulation (to the
    bit) and the single device (epoch totals within DP_FREE_TOTAL_RTOL);
    prints ms an epoch and the idle share per rank. ``cache`` keeps the
    emulations and single-device runs for the runs that share them.
    Returns (largest |d| against the emulation, launches summed over the
    ranks)."""
    rs = rs_of(n, rs_env)
    key = (cfg, n, rs, epochs)
    if key not in cache:
        cache[key] = ring_emulation(torch, cfg, n, rs, epochs)
    if (cfg, epochs) not in cache:
        cache[cfg, epochs] = single_device_run(torch, cfg, epochs)
    emu_costs, emu_params, idx = cache[key]
    ref_costs, _ = cache[cfg, epochs]
    nb = len(ref_costs[0])
    entry = "megastep_ring_epoch" if cfg == "mnist_cnn" else "deep_ring_epoch"
    want = {fn.__name__: 0 for fn in dp_wrappers() + ring_wrappers()}
    want[entry] = epochs
    want["ring_exchange"] = epochs * nb * RING_EXCHANGES[rs]
    d = 0.0
    for out in ranks:
        assert out["ring"], name
        d = max(d, max(float(abs(a - b).max())
                       for a, b in zip(out["costs"], emu_costs)))
        d = max(d, max(float(abs(a - b).max())
                       for i, lb in zip(idx, emu_params)
                       for a, b in zip(out["params"][i], lb)))
        assert out["launches"] == want, (out["launches"], want)
    same = all((a == b).all() for o in ranks[1:]
               for la, lb in zip(ranks[0]["params"], o["params"])
               for a, b in zip(la, lb))
    totals = [round(float(c.sum()), 4) for c in ranks[0]["costs"]]
    ref_tot = [round(float(c.sum()), 4) for c in ref_costs]
    print(f"  {name}, world {n} ({'reduce-scatter' if rs else 'gather'}, "
          f"{epochs} epoch(s) of {nb} steps, {20 // n} a rank): epoch ms "
          + "; ".join(f"rank {r} {[round(t, 3) for t in o['ms']]}, idle "
                      f"{100 * o['idle_share']:.1f}%"
                      for r, o in enumerate(ranks))
          + f"; ranks' params bit-identical: {same}; costs and params vs "
          f"the emulation max|d| {d:.3e}; epoch totals {totals} (single "
          f"device {ref_tot}); launches a rank {ranks[0]['launches']}",
          flush=True)
    assert same and d == 0.0, (same, d)
    assert [o["wrote_checkpoint"] for o in ranks] == [True] + [False] * (
        n - 1)
    for c, r in zip(ranks[0]["costs"], ref_costs):
        assert abs(float(c.sum()) - float(r.sum())) <= (
            DP_FREE_TOTAL_RTOL * abs(float(r.sum()))), (c.sum(), r.sum())
    return d, {k: sum(o["launches"][k] for o in ranks)
               for k in (fn.__name__ for fn in ring_wrappers())}


def phase18(torch, card, mesh):
    """The ring main path. Returns (launches of the ring wrappers in it,
    {name: world-1 results}, the largest |d| of the real ranks against
    their emulations)."""
    for fn in ring_wrappers():
        fn.launches = 0
    world1 = {name: ring_world1(torch, name, mesh, card)
              for name in ("mnist_cnn", "galaxy_rbf")}
    launches = {fn.__name__: fn.launches for fn in ring_wrappers()}
    assert launches == {"megastep_ring_epoch": DP_EPOCHS,
                        "deep_ring_epoch": DP_EPOCHS,
                        "ring_exchange": 0}, launches
    d_ranks, cache = 0.0, {}
    with tempfile.TemporaryDirectory() as tmp:
        for n, runs, epochs in ((2, RING_WORLD2, DP_EPOCHS),
                                (4, RING_WORLD4, RING_WORLD4_EPOCHS)):
            ranks, wall = ring_ranks(torch, n, runs, epochs, tmp)
            print(f"  world {n} (gloo, {n} processes on the card, the ring "
                  f"over CUDA IPC): {wall:.1f} s for {len(runs)} run(s)",
                  flush=True)
            for name, cfg, rs_env in runs:
                d, counts = check_ring_run(torch, name, cfg, rs_env, n,
                                           ranks[name], epochs, cache)
                d_ranks = max(d_ranks, d)
                for k, v in counts.items():
                    launches[k] += v
    print(f"kernel launches in the ring main path: {launches}", flush=True)
    assert all(v > 0 for v in launches.values()), launches
    return launches, world1, d_ranks


# ----------------------------------------------------------- phases 19-20

# params/synth_aux.prms as shipped (SEED 2718, 3 epochs) on synth_aux: the
# JAX package's CPU run (jax_cpu_reference.sh), its test-row costs and
# final test error in percent. The port's final test error is held within
# AUX_ERR_MARGIN points of it, fused and per layer.
AUX_JAX = dict(costs=(208.04, 14.53, 3.94), test_err=0.00)
AUX_ERR_MARGIN = {"fused": 2.0, "per-layer": 3.0}
# phase 19's bound: |kernel - twin| of each state tensor after each step at
# most AUX_REL times the larger of 1 and the tensor's largest magnitude
AUX_REL = 1e-5
# galaxy_rbf's shapes (3 x 28 x 28, Color + Elastic, conv 8 -> 16) under
# each other head; the step-locked run covers AUX_LOCKED_STEPS steps
AUX_LOCKED_STEPS = 40
HEAD_TAILS = {
    "hinge": [("HiddenLayer", {"n_out": 200, "pdrop": .5}),
              ("HingeLayer", {"n_out": 10})],
    "exploss": [("HiddenLayer", {"n_out": 200, "pdrop": .5}),
                ("ExpLossLayer", {"n_out": 10})],
    "nllsq": [("HiddenLayer", {"n_out": 200, "pdrop": .5}),
              ("SoftmaxLayer", {"n_out": 10, "loss": "nllsq"})],
    "nll90": [("HiddenLayer", {"n_out": 200, "pdrop": .5}),
              ("SoftmaxLayer", {"n_out": 10, "loss": "nll90"})],
    "auxconcat-softmax": [
        ("AuxConcatLayer", {"n_aux": (5, 9), "aux_type": "LocationInfo"}),
        ("HiddenLayer", {"n_out": 200, "pdrop": .5}),
        ("DropOutLayer", {"pdrop": .25}),
        ("SoftmaxLayer", {"n_out": 10})],
}


def aux_config():
    """(layers, training params, data module) of params/synth_aux.prms as
    train.py builds them."""
    from theanet_tpu_torch.data import synth_aux
    from theanet_tpu_torch.prms import load_params

    layers, tr, _ = load_params(os.path.join(REPO, "params",
                                             "synth_aux.prms"))
    layers[0][1]["img_sz"] = synth_aux.training_x.shape[-1]
    return layers, tr, synth_aux


def aux_cases(torch, dev):
    """Phase 19's nets: {name: (net, plan, x_steps, y_steps, aux_steps or
    None)}: synth_aux at full width on its data, galaxy_rbf's shapes under
    HEAD_TAILS on synth3 (the AuxConcat net with normal aux rows), and a
    flat Hinge net on synth_hard."""
    from theanet_tpu_torch.data import synth3, synth_hard

    layers, tr, data = aux_config()
    net, plan = build_net(layers, tr)
    x, y = step_rows(torch, data, 1, net.batch_sz, dev)
    aux = torch.as_tensor(data.training_aux[:x.shape[0] * net.batch_sz],
                          device=dev).reshape(x.shape[0], net.batch_sz, 4)
    cases = {"synth_aux": (net, plan, x, y, aux)}
    from theanet_tpu_torch.prms import load_params

    galaxy = load_params(os.path.join(REPO, "params", "galaxy_rbf.prms"))[0]
    galaxy[0][1].update(img_sz=28, num_maps=3)
    n = AUX_LOCKED_STEPS
    for name, tail in HEAD_TAILS.items():
        layers = galaxy[:6] + [[k, dict(a)] for k, a in tail]
        net, plan = build_net(layers, {"SEED": 1357, "BATCH_SZ": 20})
        x, y = step_rows(torch, synth3, 3, 20, dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        aux = (torch.randn((n, 20, 4), generator=gen, device=dev)
               if plan.spec.has_aux else None)
        cases[name] = (net, plan, x[:n], y[:n], aux)
    net, plan = build_net(
        [["ElasticLayer", dict(ELASTIC[1], img_sz=28)],
         ["HiddenLayer", {"n_out": 500, "pdrop": .5}],
         ["HingeLayer", {"n_out": 10}]], {"SEED": 2468, "BATCH_SZ": 20})
    x, y = step_rows(torch, synth_hard, 1, 20, dev)
    cases["flat-hinge"] = (net, plan, x[:n], y[:n], None)
    return cases


# A dense layer's leaky activation has a kink at 0: where a hidden
# pre-activation lies within the rounding gap of the kernel's and the twin's
# dense products (a tiled sum against a library one), the two may take its
# two sides, and that unit's gradient differs by its whole act' jump
# (measured on an H100: one step of mnist_stride's 600, a pre-activation of
# 2.98e-8, momenta 9.9e-5 apart). A step beyond AUX_REL whose twin has a
# dense pre-activation within KINK_ATOL of 0 is held to FLIP_ATOL instead.
KINK_ATOL = 1e-6
# step_locked resolves a flagship step at the kink when at most this many
# hidden units sit within KINK_ATOL of 0 (2**KINK_UNITS - 1 twin runs).
KINK_UNITS = 4


def dense_kink(torch, spec, params, x, bits_s, dev):
    """The smallest |pre-activation| of the twin's hidden layers at one
    step (x the step's (C0*B, HW) rows, bits_s its words), or None for a
    net with an aux layer (where the rule does not apply)."""
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_deep as deep

    if spec.has_aux:
        return None
    B, C0, H = spec.batch, spec.in_ch, spec.img
    a = megastep.augment(spec, x, bits_s[0][0, 0], bits_s[1][0],
                         bits_s[2][0], *megastep.smoothing_factors(spec, dev))
    inp = a.reshape(C0, B, H, H).transpose(0, 1)
    for k, (_, pad, cs, c, _) in enumerate(spec.levels):
        z = megastep._conv_true(inp, params[2 * k], spec.filts[k],
                                inp.shape[1], pad, cs, c)
        inp = megastep._pool(spec.pools[k], spec.ibs[k], megastep._act(
            z + params[2 * k + 1].reshape(1, -1, 1, 1), spec.acts[k],
            spec.slopes[k]))[1]
    f = (deep.mean_flatten(inp) if spec.mean_tail
         else inp.reshape(B, -1))
    j, lowest = 2 * spec.n_levels, math.inf
    for nh, kind, slope, _ in spec.pre_hidden + ((spec.n_hid, spec.act_h,
                                                  spec.slope_h, 0.0),):
        z = f @ params[j] + params[j + 1]
        lowest = min(lowest, float(z.abs().min()))
        f, j = megastep._act(z, kind, slope), j + 2
    return lowest


def family_locked(torch, name, net, plan, x, y, aux, dev):
    """A fused kernel against its twin, one step at a time from the
    kernel's state (the first step from the initial weights and random
    nonzero momenta): cost and minf within STEP_COST_ATOL, each state
    tensor within AUX_REL of the larger of 1 and its largest value; a step
    whose nearest warp has a near-rounding pixel (see step_locked), or
    (deep and flat-MLP specs) beyond AUX_REL with a dense pre-activation
    within KINK_ATOL of 0, within FLIP_ATOL. ``aux`` holds a deep net's aux
    rows (or None). Returns the largest absolute |d| of the state over all
    steps."""
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_deep as deep
    from theanet_tpu_torch.ops import megastep_mlp as mlp

    kernel, twin = family_fns(plan)
    spec = plan.spec
    dspec = (mlp.as_deep(spec) if isinstance(spec, mlp.MlpSpec)
             else spec if isinstance(spec, deep.DeepSpec) else None)
    kp = initial_state(plan, net, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    p = kp
    m = [0.01 * torch.randn(t.shape, generator=gen, device=dev) for t in kp]
    bits = megastep.epoch_noise_bits(3, 0, spec, x.shape[0], dev)
    first = worst = worst_abs = worst_flip = worst_kink = 0.0
    n_near = n_kink = 0
    t0 = time.time()
    for s in range(x.shape[0]):
        sl = slice(s, s + 1)
        b_s = tuple(b[sl] for b in bits)
        kw = {} if aux is None else {"aux_steps": aux[sl]}
        got = kernel(p, m, x[sl], y[sl], b_s, 0.1, spec, **kw)
        ref = twin(p, m, x[sl], y[sl], b_s, 0.1, spec, **kw)
        assert bool(torch.isfinite(got[2]).all()), (name, s, got[2])
        d_cost = max_abs(got[2], ref[2])
        pairs = list(zip(got[0] + got[1], ref[0] + ref[1]))
        d_abs = max(max_abs(a, b) for a, b in pairs)
        if spec.nearest and near_rounding_pixels(torch, megastep, spec, b_s,
                                                 0):
            n_near += 1
            worst_flip = max(worst_flip, d_abs, d_cost)
        else:
            assert d_cost <= STEP_COST_ATOL, (name, s, got[2], ref[2])
            d = max(max_abs(a, b) / max(1.0, float(b.abs().max()))
                    for a, b in pairs)
            kink = (dense_kink(torch, dspec, p, x[s], b_s, dev)
                    if d > AUX_REL and dspec is not None else None)
            if kink is not None and kink < KINK_ATOL:
                n_kink += 1
                worst_kink = max(worst_kink, d_abs)
            else:
                first = d if s == 0 else first
                worst = max(worst, d)
                worst_abs = max(worst_abs, d_abs)
        p, m = got[0], got[1]
    moved = max(max_abs(a, b) for a, b in zip(p, kp))
    if isinstance(spec, deep.DeepSpec):
        geometry = ", ".join(f"{mode}/{cs}" for mode, cs in zip(
            spec.modes, spec.conv_strides)) + (" + mean" if spec.mean_tail
                                                else "")
        what = (f"head {spec.head}, loss {spec.loss}, {spec.n_levels} conv "
                f"levels [{geometry}], aux {spec.has_aux}")
    else:
        what = (f"{type(spec).__name__}, BATCH_SZ {spec.batch}, "
                f"{spec.n_out} outputs")
    print(f"  {name} ({what}, {len(kp)} state tensors): one step |d| state "
          f"{first:.3e}; {x.shape[0]} steps step-locked |d| state "
          f"{worst:.3e} (relative to max(1, largest value); absolute "
          f"{worst_abs:.3e}; {n_near} steps with a near-rounding pixel: "
          f"{worst_flip:.3e}; {n_kink} beyond it with a dense pre-activation "
          f"within {KINK_ATOL:g} of 0: {worst_kink:.3e}); params moved "
          f"{moved:.3e} [{time.time() - t0:.1f} s]", flush=True)
    assert moved > 0
    assert worst <= AUX_REL and max(worst_flip, worst_kink) <= FLIP_ATOL, (
        name, worst, worst_flip, worst_kink)
    return worst_abs


def phase19(torch, dev):
    """The deep kernel's heads and aux stages against the twin. Returns the
    largest absolute |d| of the state."""
    from theanet_tpu_torch.ops import megastep_deep as deep

    saved = deep.deep_epoch.launches
    worst = max(family_locked(torch, name, *case, dev)
                for name, case in aux_cases(torch, dev).items())
    deep.deep_epoch.launches = saved   # the checks do not count
    return worst


def counted_cli(train, data, name, text, want_deep):
    """train.main on ``data`` with the .prms ``text`` under ``name``;
    checks the launches (``want_deep`` deep_epoch launches, nothing else).
    Returns the epoch rows."""
    with open(name + ".prms", "w") as f:
        f.write(text)
    out, counts = counted_run(train, ["train", data, name + ".prms"])
    want = {k: 0 for k in counts}
    want["deep_epoch"] = want_deep
    assert counts == want, (name, counts)
    assert "Device : cuda" in out
    rows = epoch_rows(out)
    assert all(math.isfinite(r[1]) for r in rows), rows
    return rows


def aux_epoch_times(torch, card):
    """One synth_aux epoch by the fused Trainer (the kernel), by the
    per-layer Trainer, and the twin's epoch on the card, by CUDA events;
    the kernel epoch's bound. Returns (kernel ms, per-layer ms, twin ms,
    bound)."""
    from theanet_tpu_torch.model import NeuralNet
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_deep as deep
    from theanet_tpu_torch.trainer import Trainer

    saved = deep.deep_epoch.launches
    ms = {}
    for mode in ("auto", False):
        layers, tr, data = aux_config()
        tr["MEGAFUSED"] = mode
        trainer = Trainer(NeuralNet(layers, tr), *dp_arrays(data),
                          **aux_arrays(data))
        assert (trainer._mega is not None) == (mode == "auto")
        trainer.run_epoch()   # warm-up
        ms[mode] = [timed_once(torch, trainer.run_epoch) for _ in range(2)]
        if mode == "auto":
            fused = trainer
    spec, nb = fused._mega_spec, fused.n_train_batches
    kp, km = fused._kp, fused._km
    x, y, aux = fused._mega_x, fused._mega_y, fused._mega_aux
    bits = megastep.epoch_noise_bits(3, 0, spec, nb, x.device)
    ms_twin = timed_once(torch, lambda: deep.deep_epoch_reference(
        kp, km, x, y, bits, 0.1, spec, aux))
    bnd = epoch_bound(spec, [x, y, aux, *bits, *kp, *km],
                      [*kp, *km, torch.empty((nb, 2))], nb)
    profile_epoch(torch, fused.run_epoch, nb, "one synth_aux epoch", top=8)
    deep.deep_epoch.launches = saved   # timing launches do not count
    print(f"  synth_aux, one epoch ({nb} steps x {spec.batch}) on {card}: "
          f"fused kernel {ms['auto']} ms, per layer {ms[False]} ms, twin "
          f"{ms_twin:.1f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    return min(ms["auto"]), min(ms[False]), ms_twin, bnd


def phase20(torch, card):
    """The synth_aux main path: train.main fused (3 epochs, one kernel
    launch an epoch, then a 1-epoch resume) and per layer; their test
    errors against the JAX package's CPU run; epoch times; a world-2 ring
    run. Returns ({kernel: launches in the main path}, epoch times)."""
    from theanet_tpu_torch import train

    with open(os.path.join(REPO, "params", "synth_aux.prms")) as f:
        text = f.read()
    epochs = aux_config()[1]["NUM_EPOCHS"]
    launches = {"deep_epoch": 0}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            fused = counted_cli(train, "synth_aux", "synth_aux", text, epochs)
            launches["deep_epoch"] += epochs
            resume_one_epoch(train, "synth_aux", launches, "synth_aux")
            per_layer = counted_cli(
                train, "synth_aux", "synth_aux_per_layer",
                text.replace("'SEED':", "'MEGAFUSED': False, 'SEED':"), 0)
        finally:
            os.chdir(cwd)
    for kind, rows in (("fused", fused), ("per-layer", per_layer)):
        costs, final = [r[1] for r in rows[:-1]], rows[-1][2]
        print(f"  synth_aux {kind}, SEED 2718: test-row costs {costs} (JAX "
              f"CPU {list(AUX_JAX['costs'])}); final test error "
              f"{final:.2f}% (JAX CPU {AUX_JAX['test_err']:.2f}%)",
              flush=True)
        assert len(costs) == len(AUX_JAX["costs"]), rows
        assert final <= AUX_JAX["test_err"] + AUX_ERR_MARGIN[kind], final
    times = aux_epoch_times(torch, card)
    with tempfile.TemporaryDirectory() as tmp:
        for fn in ring_wrappers():
            fn.launches = 0
        runs = (("synth_aux", "synth_aux", "auto"),)
        ranks, wall = ring_ranks(torch, 2, runs, DP_EPOCHS, tmp)
        print(f"  world 2 (gloo, 2 processes on the card, the ring over "
              f"CUDA IPC): {wall:.1f} s", flush=True)
        _, counts = check_ring_run(torch, "synth_aux", "synth_aux", "auto", 2,
                                   ranks["synth_aux"], DP_EPOCHS, {})
        launches.update(counts)
    print(f"kernel launches in the synth_aux main path: {launches}",
          flush=True)
    assert launches["deep_epoch"] and launches["deep_ring_epoch"], launches
    return launches, times


# ----------------------------------------------------------- phases 21-22

# Phase 21's small cases: the geometries of tests/test_fused_modes.py's
# CASES, an even 'same' filter, a MeanLayer after a valid stack, two
# wide levels 1 in the input gradient's long forms (a 256-wide input at 12
# maps: one row a band, the canvas wider than the block; a 1030-wide one:
# a thread two positions), and the weight gradient's long forms (64 maps
# over 64 input maps at filter 5: 3216 thread tiles, a thread's tiles one
# after another; 64 maps over a 200-wide level 0: two map groups, bands of
# a row), each (img, [(maps, filter, stride, mode, pool
# or None)], MeanLayer) at
# BATCH_SZ 4 with L2 and max-norm on the convs, GEOM_LOCKED_STEPS steps of
# random pixels step-locked (the wide cases GEOM_WIDE_STEPS: their twin's
# tap-by-tap conv takes seconds a step at 1032 x 1032)
GEOM_SMALL = {
    "same-stack": (10, [(3, 3, 1, "same", 2), (4, 3, 1, "same", 2)], False),
    "stride2": (14, [(3, 3, 2, "valid", 2)], False),
    "stride2-nopool": (14, [(3, 3, 2, "valid", None),
                            (4, 2, 1, "valid", 2)], False),
    "pool-gt-filter": (13, [(3, 3, 1, "valid", 5)], False),
    "same-then-stride": (12, [(2, 3, 1, "same", 2), (3, 3, 2, "valid", 2)],
                         False),
    "full-l0": (11, [(3, 3, 1, "full", 3)], False),
    "full-l1": (12, [(2, 3, 1, "valid", 2), (3, 2, 1, "full", 4)], False),
    "full-full": (13, [(2, 3, 1, "full", 6), (3, 3, 1, "full", 4)], False),
    "same-even-filter": (10, [(3, 4, 1, "same", 2), (4, 2, 1, "same", 2)],
                         False),
    "mean-after-valid": (12, [(2, 3, 1, "valid", 2), (5, 3, 1, "valid", None)],
                         True),
    "wide-l1": (258, [(2, 3, 1, "valid", None), (12, 3, 1, "valid", 2)],
                True),
    "wider-l1": (1032, [(2, 3, 1, "valid", None), (2, 3, 1, "valid", 2)],
                 True),
    "wgrad-passes-l1": (16, [(64, 5, 1, "valid", None),
                             (64, 5, 1, "valid", 2)], True),
    "wgrad-groups-l0": (202, [(64, 3, 1, "valid", 2)], True),
}
GEOM_LOCKED_STEPS = 40
GEOM_WIDE_STEPS = {"wide-l1": 4, "wider-l1": 3, "wgrad-passes-l1": 4,
                   "wgrad-groups-l0": 4}


def geometry_small(torch, name, dev):
    """(net, plan, x_steps, y_steps) of a GEOM_SMALL case: random pixels and
    labels from a seeded generator on the card."""
    img, cfgs, mean = GEOM_SMALL[name]
    layers = [["InputLayer", {"img_sz": img}]]
    for maps, f, stride, mode, pool in cfgs:
        layers.append(["ConvLayer", {
            "num_maps": maps, "filter_sz": f, "stride": stride, "mode": mode,
            "actvn": "relu07", "reg": {"L2": 1e-3, "maxnorm": 0.8}}])
        if pool:
            layers.append(["PoolLayer", {"pool_sz": pool}])
    if mean:
        layers.append(["MeanLayer", {}])
    layers += [["HiddenLayer", {"n_out": 10, "pdrop": .5, "actvn": "relu02",
                                "reg": {"L1": 1e-4}}],
               ["SoftmaxLayer", {"n_out": 4}]]
    net, plan = build_net(layers, {"SEED": 23, "BATCH_SZ": 4})
    gen = torch.Generator(device=dev).manual_seed(5)
    n = GEOM_WIDE_STEPS.get(name, GEOM_LOCKED_STEPS)
    x = torch.rand((n, 4, img * img), generator=gen, device=dev)
    y = torch.randint(0, 4, (n, 4), generator=gen, device=dev,
                      dtype=torch.int32)
    return net, plan, x, y


def phase21(torch, dev, card):
    """The deep kernel's conv geometry against the twin, step-locked: the
    four GEOM_CONFIGS at full width over a 600-step epoch of synth_hard and
    the GEOM_SMALL cases; then deep_grad_step (10 a rank) and the ring epoch
    entry at two emulated ranks on mnist_same against their plain versions.
    Returns (largest |d| of the epoch entry, phase15_case's results,
    largest |d| of the ring entry)."""
    from theanet_tpu_torch.ops import megastep_deep as deep

    wrappers = (deep.deep_epoch,) + dp_wrappers() + ring_wrappers()
    saved = [fn.launches for fn in wrappers]
    worst = 0.0
    for name in GEOM_CONFIGS:
        net, plan, x, y = load_config(torch, name, dev)
        worst = max(worst, family_locked(torch, name, net, plan, x, y, None,
                                       dev))
    for name in GEOM_SMALL:
        worst = max(worst, family_locked(
            torch, name, *geometry_small(torch, name, dev), None, dev))
    dp_err = phase15_case(torch, "mnist_same", 10, dev, card)
    ring_err = ring_locked(torch, "mnist_same", "0", dev)
    for fn, k in zip(wrappers, saved):   # the checks do not count
        fn.launches = k
    return worst, dp_err, ring_err


def phase22(torch, card):
    """The geometry main path: train.main on synth_hard with
    geometry_text("mnist_same") (GEOM_EPOCHS epochs, one deep_epoch launch
    an epoch and no other kernel launch, then a 1-epoch resume), its test
    error against the JAX package's CPU run; one epoch of each GEOM_CONFIGS
    entry timed on the kernel and the twin; mnist_same at world 2 on the
    ring, bit-equal to its emulation. Returns ({kernel: launches in the
    main path}, {config: (kernel ms, twin ms, bound)})."""
    from theanet_tpu_torch import train
    from theanet_tpu_torch.ops import conv3x3
    from theanet_tpu_torch.ops import megastep_deep as deep

    others = ring_wrappers() + (conv3x3.conv3x3_forward,
                                conv3x3.conv3x3_backward)
    for fn in others:
        fn.launches = 0
    launches = {"deep_epoch": 0}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            rows = counted_cli(train, "synth_hard", "mnist_same",
                               geometry_text("mnist_same"), GEOM_EPOCHS)
            launches["deep_epoch"] += GEOM_EPOCHS
            resume_one_epoch(train, "mnist_same", launches, "synth_hard")
        finally:
            os.chdir(cwd)
    assert all(fn.launches == 0 for fn in others), [
        (fn.__name__, fn.launches) for fn in others]
    costs, final = [r[1] for r in rows[:-1]], rows[-1][2]
    print(f"  mnist_same, SEED {MAIN_SEED}: test-row costs {costs} (JAX CPU "
          f"{list(GEOM_JAX['costs'])}); final test error {final:.2f}% (JAX "
          f"CPU {GEOM_JAX['test_err']:.2f}%)", flush=True)
    assert len(costs) == len(GEOM_JAX["costs"]), rows
    assert final <= GEOM_JAX["test_err"] + ERR_MARGIN, final
    saved = deep.deep_epoch.launches
    times = {name: time_config(torch, name, torch.device("cuda"), card)
             for name in GEOM_CONFIGS}
    deep.deep_epoch.launches = saved
    with tempfile.TemporaryDirectory() as tmp:
        for fn in ring_wrappers():
            fn.launches = 0
        runs = (("mnist_same", "mnist_same", "auto"),)
        ranks, wall = ring_ranks(torch, 2, runs, DP_EPOCHS, tmp)
        print(f"  world 2 (gloo, 2 processes on the card, the ring over "
              f"CUDA IPC): {wall:.1f} s", flush=True)
        _, counts = check_ring_run(torch, "mnist_same", "mnist_same", "auto",
                                   2, ranks["mnist_same"], DP_EPOCHS, {})
        launches.update(counts)
    print(f"kernel launches in the geometry main path: {launches}",
          flush=True)
    assert launches["deep_epoch"] and launches["deep_ring_epoch"], launches
    return launches, times


# ------------------------------------------------------------ phases 23-24

# Phase 23: heads and batches beyond the route rule's head threshold, each
# on synth_hard (its labels 0-9 are valid under any head): mnist_cnn's
# layers at BATCH_SZ 3000 (the JAX package tiles it as 100 tiles of 30; a
# 252,000-byte threshold head), at B 128 with 457 classes (4 tiles of 32),
# at B 20 with 1453 classes (untiled; 232,560 bytes, 112 above the
# threshold); flat_mlp's layers at B 128 with 457 classes; a three-level
# conv net at B 20 with 1500 classes.
HEAD_CONFIGS = ("mnist_b3000", "mnist_b128_457", "mnist_b20_1453",
                "flat_b128_457", "three_level_b20_1500")
HEAD_LOCKED_STEPS = 20
B3K, B3K_EPOCHS = 3000, 3
# the batches at which phase 23 times the fused epoch beside the per-layer
# one (ROADMAP fault 3): from the JAX Trainer's first per-layer batch under
# 'auto' (BATCH_SZ > 128) up to B3K; CROSSOVER_REPS epochs of each,
# alternated, after one warm-up epoch of each
CROSSOVER_BATCHES = (256, 512, 1024, 2048, B3K)
CROSSOVER_REPS = 7
# synth_hard's test set (2000 samples) holds no batch of 3000: the CLI run
# at B3K reads synth_hard drawn with 3000 test samples (make_dataset's
# n_test; the same training set, and its first 2000 test samples are
# synth_hard's), registered as data.B3K_DATA for the run.
B3K_DATA = "synth_hard_3k"
# The JAX package's CPU run of b3k_text(megafused=False) on B3K_DATA
# (jax_cpu_reference.sh, its per-layer path: the oracle
# tests/test_megastep_tiled.py pins its tiled kernel to): the cost on each
# test row and the final test error, in percent. Held as phase 8 holds
# galaxy_rbf's: each row within SEED_COST_RTOL, the final error at most
# ERR_MARGIN above.
B3K_JAX = dict(costs=(9.76, 9.48, 9.44), test_err=90.57)


def b3k_text(epochs=B3K_EPOCHS, megafused=True):
    """params/mnist_cnn.prms at BATCH_SZ B3K, SEED MAIN_SEED, NUM_EPOCHS
    ``epochs`` and MEGAFUSED ``megafused``."""
    with open(os.path.join(REPO, "params", "mnist_cnn.prms")) as f:
        text = f.read()
    bsz, n_ep = "'BATCH_SZ':            20,", "'NUM_EPOCHS':          101,"
    assert bsz in text and n_ep in text
    text = text.replace(bsz, f"'BATCH_SZ':            {B3K}, 'SEED': "
                        f"{MAIN_SEED}, 'MEGAFUSED': {megafused},")
    return text.replace(n_ep, f"'NUM_EPOCHS':          {epochs},")


def register_b3k_data(make_dataset):
    """Register data.B3K_DATA, where train.main's load_dataset looks first:
    ``make_dataset`` (a synth_hard module's) with 3000 test samples."""
    import types

    import data  # noqa: F401  (the checkout's data/ plugin package)

    mod = types.ModuleType("data." + B3K_DATA)
    (mod.training_x, mod.training_y, mod.testing_x,
     mod.testing_y) = make_dataset(n_test=B3K)
    sys.modules[mod.__name__] = mod


HEAD_SHAPES = {   # BATCH_SZ, classes
    "mnist_b3000": (B3K, 10), "mnist_b128_457": (128, 457),
    "mnist_b20_1453": (20, 1453), "flat_b128_457": (128, 457),
    "three_level_b20_1500": (20, 1500)}


# The configurations whose stage plans the mirror check covers (and
# tests/test_torch_stage_plan.py pins on the CPU), as (name, BATCH_SZ or
# None for its own): every shipped .prms, the per-rank batches of the
# data-parallel and ring runs (20 over 2 and 4 ranks), phase 23's
# configurations and the geometry configurations.
SHIPPED_PRMS = ("mnist_cnn", "galaxy_rbf", "logit_centered", "synth_quick",
                "flat_mlp", "synth_aux")
# phase 25's configuration: params/gtsrb_mcdnn.prms on signs48's 3 x 48 x 48
GTSRB = "gtsrb_mcdnn"
PLAN_CONFIGS = ([(n, None) for n in SHIPPED_PRMS] + [(GTSRB, None)]
                + [(n, b) for n in ("mnist_cnn", "galaxy_rbf", "flat_mlp")
                   for b in (5, 10)]
                + [("synth_aux", 10), ("mnist_same", 10)]
                + [(n, None) for n in HEAD_CONFIGS]
                + [(n, None) for n in GEOM_CONFIGS])


def head_config(name):
    """(layers, training params) of a HEAD_CONFIGS entry at synth_hard's
    28 x 28: mnist_cnn.prms's or flat_mlp.prms's layers with the entry's
    batch and classes, or the three-level net (Conv 4@3 -> Pool 2 -> Conv
    8@3 -> Pool 2 -> Conv 8@2 -> Hidden 200 -> Softmax) with mnist_cnn's
    augmentation and training parameters; SEED MAIN_SEED."""
    from theanet_tpu_torch.prms import load_params

    src = "flat_mlp" if name.startswith("flat") else "mnist_cnn"
    layers, tr, _ = load_params(os.path.join(REPO, "params", src + ".prms"))
    if name.startswith("three_level"):
        conv = lambda m, f, a: ["ConvLayer", {"num_maps": m, "filter_sz": f,
                                              "stride": 1, "actvn": a}]
        layers = [layers[0], conv(4, 3, "relu10"), ["PoolLayer",
                  {"pool_sz": 2}], conv(8, 3, "relu05"), ["PoolLayer",
                  {"pool_sz": 2}], conv(8, 2, "relu05"),
                  ["HiddenLayer", {"n_out": 200, "pdrop": .5}],
                  ["SoftmaxLayer", {"n_out": 10}]]
    batch, n_out = HEAD_SHAPES[name]
    layers[0][1]["img_sz"] = 28
    layers[-1][1]["n_out"] = n_out
    tr.update(SEED=MAIN_SEED, BATCH_SZ=batch)
    return layers, tr


def head_rows(torch, batch, n_steps, dev):
    """synth_hard's step rows at ``batch``, its epoch repeated up to
    ``n_steps`` steps (None: one epoch)."""
    from theanet_tpu_torch.data import synth_hard

    x, y = step_rows(torch, synth_hard, 1, batch, dev)
    if n_steps is None:
        return x, y
    reps = -(-n_steps // x.shape[0])
    return x.repeat(reps, 1, 1)[:n_steps], y.repeat(reps, 1)[:n_steps]


def b3k_cli(train):
    """train.main with b3k_text() on data.B3K_DATA, B3K_EPOCHS epochs and a
    1-epoch resume: one megastep_epoch launch an epoch and nothing else.
    Returns (epoch rows of the first run, {kernel: launches})."""
    from theanet_tpu_torch.data.synth_hard import make_dataset

    register_b3k_data(make_dataset)
    launches = {"megastep_epoch": 0}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            with open("mnist_b3000.prms", "w") as f:
                f.write(b3k_text())
            out, counts = counted_run(train, ["train", B3K_DATA,
                                              "mnist_b3000.prms"])
            want = {k: 0 for k in counts}
            want["megastep_epoch"] = B3K_EPOCHS
            assert counts == want, counts
            assert "Device : cuda" in out
            rows = epoch_rows(out)
            launches["megastep_epoch"] += B3K_EPOCHS
            resume_one_epoch(train, "mnist_b3000", launches, B3K_DATA,
                             "megastep_epoch")
        finally:
            os.chdir(cwd)
    return rows, launches


def crossover_times(torch, Trainer, NeuralNet, tx, ty, batch, card):
    """mnist_cnn's layers at ``batch`` on synth_hard: the fused and the
    per-layer Trainer's epochs, one warm-up each, then CROSSOVER_REPS of
    each alternated, each timed by CUDA events. Returns {path: (median,
    min, max) ms}."""
    import statistics

    trainers = {}
    for path, fused in (("fused", True), ("per_layer", False)):
        layers, tr = head_config("mnist_b3000")
        tr.update(BATCH_SZ=batch, MEGAFUSED=fused)
        trainers[path] = Trainer(NeuralNet(layers, tr), tx, ty, tx[:B3K],
                                 ty[:B3K])
        assert (trainers[path]._mega is not None) == fused, path
        trainers[path].run_epoch()   # warm-up
    ms = {path: [] for path in trainers}
    for _ in range(CROSSOVER_REPS):
        for path, trainer in trainers.items():
            ms[path].append(timed_once(torch, trainer.run_epoch))
    out = {path: (statistics.median(t), min(t), max(t))
           for path, t in ms.items()}
    print(f"  mnist_cnn at BATCH_SZ {batch}, {CROSSOVER_REPS} epochs each "
          f"alternated on {card}: " + "; ".join(
              f"{path} median {m:.3f} ms (min {lo:.3f}, max {hi:.3f})"
              for path, (m, lo, hi) in out.items()), flush=True)
    return out


def phase23(torch, dev, card):
    """The heads and batches beyond the route rule's head threshold
    (HEAD_CONFIGS): each kernel against its twin, one step and
    HEAD_LOCKED_STEPS steps step-locked; a timed and profiled epoch of
    kernel and twin (the head's stages beside its bound); megastep_grad_step (at
    mnist_b128_457) and deep_grad_step (at three_level_b20_1500) against
    their plain versions; then train.main at BATCH_SZ B3K with MEGAFUSED
    True (B3K_EPOCHS epochs and a resume, one launch an epoch), its test
    rows against the JAX package's CPU run; then, at each of
    CROSSOVER_BATCHES, the fused epochs beside the per-layer ones
    (crossover_times). Returns
    ({kernel: launches in the main path}, {epoch kernel: {config: (largest
    |d|, times)}, "crossover": {batch: crossover_times}}, the DP
    cases' results)."""
    import numpy as np
    from theanet_tpu_torch import train
    from theanet_tpu_torch.data import synth_hard
    from theanet_tpu_torch.model import NeuralNet
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_deep as deep
    from theanet_tpu_torch.ops import megastep_mlp as mlp
    from theanet_tpu_torch.trainer import Trainer

    tx, ty = dp_arrays(synth_hard)[:2]
    wrappers = (megastep.megastep_epoch, deep.deep_epoch,
                mlp.mlp_epoch) + dp_wrappers()
    saved = [fn.launches for fn in wrappers]
    results, dp_res = {}, {}
    for name in HEAD_CONFIGS:
        layers, tr = head_config(name)
        net, plan = build_net(layers, tr)
        assert head_bytes(plan) > 227 * 1024, name
        assert plan.spec.batch == HEAD_SHAPES[name][0], plan.spec
        x, y = head_rows(torch, plan.spec.batch, HEAD_LOCKED_STEPS, dev)
        err = family_locked(torch, name, net, plan, x, y, None, dev)
        times = time_config(torch, name, dev, card, (
            net, plan, *head_rows(torch, plan.spec.batch, None, dev)))
        results.setdefault(plan.epoch_fn.__name__, {})[name] = (err, times)
        if name in ("mnist_b128_457", "three_level_b20_1500"):
            mplan = megastep.fused_plan(net, for_mesh=True)
            xs = torch.as_tensor(tx, device=dev)
            ys = torch.as_tensor(np.asarray(ty, np.int32), device=dev)
            dp_res.update(phase15_case(
                torch, name, plan.spec.batch, dev, card,
                setup=(net, mplan, initial_state(mplan, net, dev), xs, ys)))
    for fn, k in zip(wrappers, saved):   # the checks do not count
        fn.launches = k

    rows, launches = b3k_cli(train)
    costs, final = [r[1] for r in rows[:-1]], rows[-1][2]
    print(f"  mnist_cnn.prms at BATCH_SZ {B3K}, MEGAFUSED True, SEED "
          f"{MAIN_SEED}: test-row costs {costs} (JAX CPU, per layer: "
          f"{list(B3K_JAX['costs'])}); final test error {final:.2f}% (JAX "
          f"CPU {B3K_JAX['test_err']:.2f}%); launches {launches}",
          flush=True)
    assert len(costs) == len(B3K_JAX["costs"]), rows
    for c, cj in zip(costs, B3K_JAX["costs"]):
        assert abs(c - cj) <= SEED_COST_RTOL * cj, (c, cj)
    assert final <= B3K_JAX["test_err"] + ERR_MARGIN, final

    # Fault 3: the JAX Trainer's 'auto' keeps a spec it tiles above
    # BATCH_SZ 128 per layer (a crossover measured on the TPU); here the
    # fused Trainer (MEGAFUSED True) beside the per-layer one at
    # CROSSOVER_BATCHES, their epochs alternated
    saved = megastep.megastep_epoch.launches
    crossover = {}
    for batch in CROSSOVER_BATCHES:
        crossover[batch] = crossover_times(torch, Trainer, NeuralNet, tx, ty,
                                           batch, card)
    megastep.megastep_epoch.launches = saved   # timing launches do not count
    results["crossover"] = crossover
    return launches, results, dp_res


def gtsrb_config():
    """(layers, training params) of params/gtsrb_mcdnn.prms on signs48's
    3 x 48 x 48 images, SEED MAIN_SEED."""
    from theanet_tpu_torch.prms import load_params

    layers, tr, _ = load_params(os.path.join(REPO, "params", GTSRB + ".prms"))
    layers[0][1].update(img_sz=48, num_maps=3)
    tr["SEED"] = MAIN_SEED
    return layers, tr


# Phase 25: the GTSRB column at its published widths. Its conv levels
# (Cin 3 -> 100 maps at 7x7, 100 -> 150 and 150 -> 250 at 4x4) are the
# widest any phase runs through csrc/megastep_deep.cu and csrc/stages.cuh.
# GTSRB_LOCKED_STEPS steps step-locked, an epoch of GTSRB_TIMED_STEPS steps
# timed (the twin sums each conv tap by tap: 0.15 s a step on the card),
# and the CLI's main path for GTSRB_EPOCHS epochs on the whole signs48
# set (39,209 training images, 1960 steps an epoch).
GTSRB_LOCKED_STEPS = 24
GTSRB_TIMED_STEPS = 60
GTSRB_EPOCHS = 3


def gtsrb_text(epochs=GTSRB_EPOCHS):
    """params/gtsrb_mcdnn.prms with SEED MAIN_SEED and NUM_EPOCHS
    ``epochs``."""
    import ast

    with open(os.path.join(REPO, "params", GTSRB + ".prms")) as f:
        prms = ast.literal_eval(f.read())
    tr = dict(prms["training_params"], SEED=MAIN_SEED, NUM_EPOCHS=epochs)
    return repr({"layers": prms["layers"], "training_params": tr}) + "\n"


def dgrad_paths(torch, spec, dev, card):
    """At each input-gradient level of ``spec`` whose plan takes the tiled
    path, both paths on the same seeded dz and weights: the tiled din
    equal to the band path's bit for bit (torch.equal; both written over
    NaNs), then each path's us a launch by CUDA events beside the level's
    bound (its valid taps at the f32 rate, or its bytes)."""
    from theanet_tpu_torch.ops import _build
    from theanet_tpu_torch.ops import stage_plan as sp

    gen = torch.Generator(device=dev).manual_seed(MAIN_SEED)
    total = {0: 0.0, 1: 0.0}
    flops = n_bytes = 0
    for g in sp.dgrad_tiled_levels(spec):
        w = torch.randn((g.M, g.F * g.F * g.Cin), device=dev,
                        generator=gen) / (g.F * g.M ** 0.5)
        dz = torch.randn((g.B, g.M, g.c, g.c), device=dev, generator=gen)
        dz[:, :, g.e:] = 0.0
        dz[:, :, :, g.e:] = 0.0
        din = {}
        for path in (0, 1):
            din[path] = torch.full((g.B, g.Cin, g.W, g.W), float("nan"),
                                   device=dev)
            _build.deep_conv_dgrad_launch(g, path, w, dz, din[path])
        torch.cuda.synchronize()
        assert torch.equal(din[0], din[1]), max_abs(din[0], din[1])
        us = {path: 1e3 * timed(torch, lambda p=path: _build
                                .deep_conv_dgrad_launch(g, p, w, dz,
                                                        din[p]), 20)
              for path in (0, 1)}
        lf = 2 * g.B * g.M * g.e * g.e * g.F * g.F * g.Cin
        lb = 4 * (g.B * g.M * g.c * g.c + g.M * g.F * g.F * g.Cin
                  + g.B * g.Cin * g.W * g.W)
        b_ms, by = bound(lb, lf)
        flops, n_bytes = flops + lf, n_bytes + lb
        for path in (0, 1):
            total[path] += us[path]
        p = sp.dgrad_tile_plan(g.B, g.Cin, g.W, g.M, g.F)
        print(f"  dgrad {g.Cin} -> {g.M} maps at {g.W}x{g.W}, F {g.F}, B "
              f"{g.B}: tiled din == band din (torch.equal); band "
              f"{us[0]:.1f} us, tiled {us[1]:.1f} us (grid {p.grid(g.B)} "
              f"x {p.threads}, chunks of {p.km}), bound {b_ms * 1e3:.1f} us "
              f"({by}); tiled at {100 * b_ms * 1e3 / us[1]:.1f}% of it",
              flush=True)
    b_ms, by = bound(n_bytes, flops)
    print(f"  the input-gradient stage a step on {card}: band "
          f"{total[0] / 1e3:.4f} ms, tiled {total[1] / 1e3:.4f} ms, bound "
          f"{b_ms * 1e3:.1f} us ({by})", flush=True)


def phase25(torch, dev, card):
    """The GTSRB column (params/gtsrb_mcdnn.prms) at its published widths:
    its route, the deep kernel against its twin step-locked, an epoch of
    each timed and profiled, then train.main on signs48. Returns
    ({kernel: launches in the main path}, largest |d| of the state,
    time_config's times)."""
    import types

    from theanet_tpu_torch import train
    from theanet_tpu_torch.data import signs48
    from theanet_tpu_torch.ops import megastep
    from theanet_tpu_torch.ops import megastep_deep as deep
    from theanet_tpu_torch.ops import stage_plan

    layers, tr = gtsrb_config()
    net, plan = build_net(layers, tr)
    spec = plan.spec
    assert plan.epoch_fn is deep.deep_epoch, plan.epoch_fn
    assert megastep.fused_decline_reason(net) is None
    assert stage_plan.stage_limit_reason(spec) is None
    assert (spec.batch, spec.img, spec.in_ch, spec.maps, spec.filts,
            spec.n_flat, spec.n_hid, spec.n_out) == (
        20, 48, 3, (100, 150, 250), (7, 4, 4), 2250, 300, 43), spec
    n_state = sum(t.numel() for t in initial_state(plan, net, dev))
    print(f"  {GTSRB}: deep family, no decline, no stage limit; conv levels "
          f"(maps, filter) {list(zip(spec.maps, spec.filts))}, flatten "
          f"{spec.n_flat}, {n_state:,} state floats; route-rule head "
          f"threshold {head_bytes(plan):,} bytes", flush=True)
    assert n_state == 1543443, n_state
    data = types.SimpleNamespace(**dict(zip(
        ("training_x", "training_y"), signs48.make_dataset(
            n_train=20 * GTSRB_TIMED_STEPS, n_test=20, seed=MAIN_SEED)[:2])))
    x, y = step_rows(torch, data, 3, 20, dev)
    saved = deep.deep_epoch.launches
    dgrad_paths(torch, spec, dev, card)
    err = family_locked(torch, GTSRB, net, plan, x[:GTSRB_LOCKED_STEPS],
                        y[:GTSRB_LOCKED_STEPS], None, dev)
    tiled = deep.deep_epoch.dgrad_tiled_launches
    times = time_config(torch, GTSRB, dev, card, (net, plan, x, y))
    tiled = deep.deep_epoch.dgrad_tiled_launches - tiled
    n_levels = len(stage_plan.dgrad_tiled_levels(spec))
    # time_config: 2 warm-ups, 6 timed calls, 2 profiled (one a warm-up)
    assert n_levels == 2 and tiled == 10 * x.shape[0] * n_levels, tiled
    print(f"  deep_epoch.dgrad_tiled_launches over time_config's 10 epochs "
          f"of {x.shape[0]} steps: {tiled} ({n_levels} a step)", flush=True)
    stage_lines(torch, GTSRB, dev, card)
    deep.deep_epoch.launches = saved   # the checks do not count

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.time()
            rows = counted_cli(train, "signs48", GTSRB, gtsrb_text(),
                               GTSRB_EPOCHS)
        finally:
            os.chdir(cwd)
    costs = [r[1] for r in rows[:-1]]
    print(f"  train.main signs48 {GTSRB}.prms ({GTSRB_EPOCHS} epochs, SEED "
          f"{MAIN_SEED}): test rows {rows}; {GTSRB_EPOCHS} deep_epoch "
          f"launches, no other kernel [{time.time() - t0:.1f} s]", flush=True)
    assert len(costs) == GTSRB_EPOCHS, rows
    assert costs[-1] < costs[0], costs
    return {"deep_epoch": GTSRB_EPOCHS}, err, times


# Phase 24: the probe kernels of csrc/probes.cu against their plain
# versions (PROBE_CHECK_STEPS steps: floor exact to rtol 1e-6, the section
# to SECTION_RTOL of each column's largest value, the relay rtol 1e-6),
# then the probe tools' main paths on the card at their default 3000
# steps, timed (us/step), one launch an epoch and one a step.
PROBE_CHECK_STEPS = 64
PROBE_STEPS = 3000
SECTION_RTOL = 1e-5
PROBE_RTOL = 1e-6


# phase 26: a change meant to keep the flagship's arithmetic (a stage moved
# into csrc/stages.cuh, a workspace layout changed) must give the parent
# commit's bits. The small cases train PARENT_STEPS steps.
PARENT_STEPS = 40


def parent_library(parent):
    """The flagship library of the checkout at ``parent`` (its
    csrc/megastep.cu and headers), built by nvcc with _build's flags into a
    temporary directory and bound as _build binds its own."""
    import ctypes

    from theanet_tpu_torch.ops import _build

    src = os.path.join(parent, "theanet_tpu_torch", "csrc", "megastep.cu")
    so = os.path.join(tempfile.mkdtemp(), "megastep_parent.so")
    t0 = time.time()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                   check=True, timeout=900)
    print(f"  built {src} in {time.time() - t0:.1f} s", flush=True)
    return _build._bind("megastep", ctypes.CDLL(so))


@contextlib.contextmanager
def flagship_library(lib):
    """The flagship wrappers on ``lib`` in place of the checkout's
    library."""
    from theanet_tpu_torch.ops import _build

    own = _build.build()["megastep"]
    _build._libs["megastep"] = lib
    try:
        yield
    finally:
        _build._libs["megastep"] = own


def kernel_augment(torch, megastep, spec, x, y, words, params, dev):
    """One step's augmented image (B, HW) by the current flagship library:
    megastep_grad_step's workspace after the call (csrc/megastep.cu carve:
    the warp's 2 HW floats, then the image). One channel, where the image
    is laid out the same sample-major or channel-major."""
    from theanet_tpu_torch.ops import _build

    assert spec.in_ch == 1, spec.in_ch
    ispec, fspec = _build._spec_arrays(spec)
    lib = _build.build()["megastep"]
    ws = _build._workspace("megastep", lib, ispec, fspec, dev)
    grads = torch.empty(sum(r * c for r, c in megastep.kernel_shapes(spec)),
                        device=dev)
    cm = torch.empty(2, device=dev)
    gh, gw = megastep.smoothing_factors(spec, dev)
    _build._entry("megastep", lib, "grad_step", ispec, fspec,
                  _build._ptrs([x, y, *words, gh, gw, *params, grads, cm]),
                  ws.data_ptr(), dev=dev)
    torch.cuda.synchronize()
    hw = spec.hw
    return ws[2 * hw:(2 + spec.batch) * hw].view(spec.batch, hw).clone()


def parent_cases(torch, data, dev):
    """{name: (spec, params, moms, x, y, bits)} of phase 26: mnist_cnn on
    synth_hard at BATCH_SZ 20 and 256 (one epoch each), phase 23's
    flagship configurations (HEAD_LOCKED_STEPS steps) and two of phase 2's
    variants (PARENT_STEPS steps); random momenta throughout."""
    from theanet_tpu_torch.data import synth_hard
    from theanet_tpu_torch.ops import megastep

    gen = torch.Generator(device=dev).manual_seed(13)

    def moms(p):
        return [0.01 * torch.randn(t.shape, generator=gen, device=dev)
                for t in p]

    cases = {}
    _, spec = load_flagship(torch)
    kp, _, x, y, bits = epoch_inputs(torch, megastep, spec, data, dev)
    cases["mnist_cnn_b20"] = (spec, kp, moms(kp), x, y, bits)
    spec = spec._replace(batch=256)
    x, y = step_rows(torch, synth_hard, 1, 256, dev)
    bits = megastep.epoch_noise_bits(3, 0, spec, x.shape[0], dev)
    cases["mnist_cnn_b256"] = (spec, kp, moms(kp), x, y, bits)
    for name in HEAD_CONFIGS:
        net, plan = build_net(*head_config(name))
        if plan.epoch_fn is not megastep.megastep_epoch:
            continue
        p = initial_state(plan, net, dev)
        x, y = head_rows(torch, plan.spec.batch, HEAD_LOCKED_STEPS, dev)
        bits = megastep.epoch_noise_bits(3, 0, plan.spec, x.shape[0], dev)
        cases[name] = (plan.spec, p, moms(p), x, y, bits)
    for name in ("3-channel-nearest", "smooth-acts-bilinear"):
        spec = variant_spec(megastep, SPEC_VARIANTS[name])
        p = [0.3 * torch.randn(s, generator=gen, device=dev)
             for s in megastep.kernel_shapes(spec)]
        x = torch.rand((PARENT_STEPS, spec.in_ch * spec.batch, spec.hw),
                       generator=gen, device=dev)
        y = torch.randint(0, spec.n_out, (PARENT_STEPS, spec.batch),
                          generator=gen, device=dev, dtype=torch.int32)
        bits = megastep.epoch_noise_bits(9, 0, spec, PARENT_STEPS, dev)
        cases[name] = (spec, p, moms(p), x, y, bits)
    return cases


def augment_against_twin(torch, megastep, parent_lib, spec, p, x, y, bits,
                         dev):
    """Each step's augmented image by this checkout's library and the
    parent's against the twin's ``augment``: (steps equal to the twin,
    largest |d| of the parent's from the twin)."""
    gh, gw = megastep.smoothing_factors(spec, dev)
    n_equal, d_parent = 0, 0.0
    for s in range(x.shape[0]):
        words = (bits[0][s, 0], bits[1][s], bits[2][s], bits[3][s])
        twin = megastep.augment(spec, x[s], *words[:3], gh, gw)
        own = kernel_augment(torch, megastep, spec, x[s], y[s], words, p,
                             dev)
        with flagship_library(parent_lib):
            par = kernel_augment(torch, megastep, spec, x[s], y[s], words,
                                 p, dev)
        n_equal += bool(torch.equal(own, twin))
        d_parent = max(d_parent, max_abs(par, twin))
    return n_equal, d_parent


def phase26(torch, data, dev, parent):
    """The flagship library against the parent commit's (``parent``: an
    unpacked archive of it) on parent_cases, every state tensor and cost
    row by torch.equal. A bilinear case whose bits differ passes only when
    this checkout's augmented image equals the twin's at every step (the
    parent's may differ: nvcc may contract its bilinear sum into FMAs)."""
    from theanet_tpu_torch.ops import megastep

    parent_lib = parent_library(parent)
    saved = megastep.megastep_epoch.launches
    for name, (spec, p, m, x, y, bits) in parent_cases(torch, data,
                                                       dev).items():
        got = megastep.megastep_epoch(p, m, x, y, bits, 0.1, spec)
        with flagship_library(parent_lib):
            ref = megastep.megastep_epoch(p, m, x, y, bits, 0.1, spec)
        torch.cuda.synchronize()
        pairs = list(zip(got[0] + got[1] + [got[2]],
                         ref[0] + ref[1] + [ref[2]]))
        unequal = sum(not torch.equal(a, b) for a, b in pairs)
        d = max(max_abs(a, b) for a, b in pairs)
        print(f"  {name} (B {spec.batch}, {x.shape[0]} steps): "
              f"{len(pairs) - unequal} of {len(pairs)} state tensors and "
              f"cost rows equal to the parent's; max|d| {d:.3e}",
              flush=True)
        if not unequal:
            continue
        assert not spec.nearest and megastep.warp_active(spec), name
        n_equal, d_parent = augment_against_twin(
            torch, megastep, parent_lib, spec, p, x, y, bits, dev)
        print(f"    augmented images: this checkout's equal to the twin's "
              f"at {n_equal} of {x.shape[0]} steps; the parent's max|d| "
              f"from the twin {d_parent:.3e}", flush=True)
        assert n_equal == x.shape[0], (name, n_equal)
    megastep.megastep_epoch.launches = saved   # the checks do not count


def probe_checks(torch, dev):
    """Each probe kernel against its plain version, in every variant and
    launch mode. Returns {kernel: largest absolute |d|}."""
    from theanet_tpu_torch.tools import conv_layout_probe as clp
    from theanet_tpu_torch.tools import floor_probe as fp

    n = PROBE_CHECK_STEPS
    worst = {"floor_probe": 0.0, "conv_section_probe": 0.0,
             "relay_probe": 0.0}
    for name in fp.VARIANTS:
        ins = fp.variant_inputs(name, n, dev)
        for out, u, per in ((o, u, per) for o in fp.OUT_WIDTH
                            for u in (1, 2) for per in (False, True)):
            got = fp.floor_probe(ins, fp.OUT_WIDTH[out], u, per)
            ref = fp.floor_reference(ins, fp.OUT_WIDTH[out], u)
            torch.cuda.synchronize()
            d = max_abs(got, ref)
            assert d <= PROBE_RTOL * float(ref.abs().max()), (name, out, u,
                                                              per, d)
            worst["floor_probe"] = max(worst["floor_probe"], d)
    print(f"  floor: {len(fp.VARIANTS)} variants x out vmem/smem x U 1/2 x "
          f"launch epoch/step, {n} steps: max|d| {worst['floor_probe']:.3e}",
          flush=True)
    x, w2, b2 = clp.section_inputs(n, dev)
    ref = clp.section_reference(x, w2, b2)
    for variant in clp.SECTION_VARIANTS:
        for per in (False, True):
            got = clp.conv_section(x, w2, b2, variant, per)
            torch.cuda.synchronize()
            rel = [max_abs(got[:, c], ref[:, c]) / float(ref[:, c].abs().max())
                   for c in range(2)]
            print(f"  section {variant} (launch {'step' if per else 'epoch'})"
                  f": step 0 {float(got[0, 0]):.7f} (plain "
                  f"{float(ref[0, 0]):.7f}); max|d| / largest value: output "
                  f"{rel[0]:.3e}, sum(dpp) {rel[1]:.3e}", flush=True)
            assert max(rel) <= SECTION_RTOL, (variant, rel)
            worst["conv_section_probe"] = max(worst["conv_section_probe"],
                                              max_abs(got, ref))
    xr = clp.relay_inputs(n, dev)
    for G, g in ((5, 4), (10, 2)):
        for per in (False, True):
            got = clp.relay_probe(xr, G, g, per)
            ref = clp.relay_reference(xr, G, g)
            torch.cuda.synchronize()
            d = max_abs(got, ref)
            assert d <= PROBE_RTOL * float(ref.abs().max()), (G, g, per, d)
            worst["relay_probe"] = max(worst["relay_probe"], d)
    print(f"  relay 5x4 and 10x2, launch epoch/step: max|d| "
          f"{worst['relay_probe']:.3e}", flush=True)
    return worst


def probe_times(torch, dev):
    """(ms, plain ms, bound, library ms) of an epoch of PROBE_STEPS steps
    of each probe kernel: floor 'mirror' (one launch), the section's block
    layout, the relay at 5x4."""
    from theanet_tpu_torch.tools import conv_layout_probe as clp
    from theanet_tpu_torch.tools import floor_probe as fp

    n = PROBE_STEPS
    ins = fp.variant_inputs("mirror", n, dev)
    x, w2, b2 = clp.section_inputs(n, dev)
    xr = clp.relay_inputs(n, dev)
    out128 = torch.empty((n, 128), device=dev)
    runs = {
        "floor_probe": (lambda: fp.floor_probe(ins, 128),
                        lambda: fp.floor_reference(ins, 128), None,
                        bound(nbytes(*ins, out128),
                              sum(t[0].numel() for t in ins) * n)),
        "conv_section_probe": (
            lambda: clp.conv_section(x, w2, b2, "block"),
            lambda: clp.section_reference(x, w2, b2), None,
            bound(nbytes(x, w2, b2) + 8 * n,
                  2 * 3 * (clp.M2 * clp.B * 169 * 36) * n)),
        "relay_probe": (lambda: clp.relay_probe(xr, 5, 4),
                        lambda: clp.relay_reference(xr, 5, 4),
                        lambda: xr.sum((1, 2)),
                        bound(nbytes(xr) + 4 * n, xr.numel())),
    }
    out = {}
    for name, (kernel, plain, lib, bnd) in runs.items():
        ms = timed(torch, kernel, 5)
        ms_p = timed(torch, plain, 1)
        ms_l = timed(torch, lib, 5) if lib else None
        out[name] = (ms, ms_p, bnd, ms_l)
        print(f"  {name}: an epoch of {n} steps {ms:.4f} ms (plain "
              f"{ms_p:.3f} ms; bound {bnd[0]:.5f} ms, {bnd[1]}"
              + (f"; x.sum((1, 2)) {ms_l:.4f} ms" if lib else "") + ")",
              flush=True)
    return out


def phase24(torch, dev, card):
    """The probes: each kernel against its plain version (the checks'
    launches do not count), their epoch times, then the tools' main paths
    with the counters set to 0 just before: floor_probe for every variant
    at one launch an epoch and one a step (and U 2, out smem), the section
    in both layouts and the relay at 5x4 and 10x2, at one launch an epoch
    and one a step. Returns ({kernel: launches}, {kernel: |d|},
    {kernel: times}, {tool run: {variant: ms}})."""
    from theanet_tpu_torch.tools import conv_layout_probe as clp
    from theanet_tpu_torch.tools import floor_probe as fp

    fns = (fp.floor_probe, clp.conv_section, clp.relay_probe)
    saved = [fn.launches for fn in fns]
    errs = probe_checks(torch, dev)
    times = probe_times(torch, dev)
    for fn, k in zip(fns, saved):
        fn.launches = k
    for fn in fns:
        fn.launches = 0
    base = ["--batches", str(PROBE_STEPS), "--chain", "2", "--reps", "2"]
    tools = {}
    for launch in ("epoch", "step"):
        tools[f"floor {launch}"] = fp.main(base + ["--launch", launch])
        tools[f"section {launch}"] = clp.main(base + ["--launch", launch])
    tools["floor U2 smem"] = fp.main(base + ["--grid-u", "2", "--out",
                                             "smem", "--variants", "mirror"])
    launches = {"floor_probe": fp.floor_probe.launches,
                "conv_section_probe": clp.conv_section.launches,
                "relay_probe": clp.relay_probe.launches}
    print(f"probe launches in the tools' main paths: {launches}", flush=True)
    assert all(launches.values()), launches
    return launches, errs, times, tools


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=None)
    ap.add_argument("--parent", default=None,
                    help="an unpacked archive of the parent commit, for "
                         "phase 26")
    args = ap.parse_args(argv)
    every = ALL_PHASES + ((PARENT_PHASE,) if args.parent else ())
    phases = {int(p) for p in (args.phases.split(",") if args.phases
                               else every)}
    if PARENT_PHASE in phases and not args.parent:
        print(f"chip_smoke: phase {PARENT_PHASE} needs --parent",
              file=sys.stderr)
        return 2

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
    print(f"built {', '.join(f'csrc/{n}.cu' for n in _build.LIBRARIES)} in "
          f"{time.time() - t0:.1f} s", flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name}:", line.strip())

    from theanet_tpu_torch.data import synth_hard

    nb = synth_hard.training_x.shape[0] // 20
    data = (torch.as_tensor(synth_hard.training_x[:nb * 20], device=dev)
            .reshape(nb, 20, 784),
            torch.as_tensor(synth_hard.training_y[:nb * 20], device=dev)
            .reshape(nb, 20))
    step_err = epoch_err = launches = timing = None
    deep_err = mlp_err = new_launches = new_timing = None
    if 2 in phases:
        banner(2, "one step, kernel vs twin (nearest and bilinear; the "
               "kernel's other options at small shapes)")
        step_err = max(phase2(torch, data, dev),
                       phase2_variants(torch, dev))
        nan_edges(torch, dev)
    if 3 in phases:
        banner(3, "one epoch, kernel vs twin")
        epoch_err = phase3(torch, data, dev)
    if 4 in phases:
        banner(4, "main path: train.main on synth_hard + resume")
        launches = phase4(torch)
    if 5 in phases:
        banner(5, "epoch time, kernel vs twin")
        timing = phase5(torch, data, dev, card)
    if 6 in phases:
        banner(6, "deep kernel vs twin: one step and a step-locked epoch "
               "of galaxy_rbf, logit_centered, synth_quick; small variants")
        deep_err = phase6(torch, dev)
    if 7 in phases:
        banner(7, "flat-MLP kernel vs twin: flat_mlp, one step and a "
               "step-locked epoch")
        mlp_err = phase7(torch, dev)
    if 8 in phases:
        banner(8, "main path: train.main for galaxy_rbf (+ resume), "
               "logit_centered, synth_quick, flat_mlp")
        new_launches = phase8(torch)
    if 9 in phases:
        banner(9, "epoch time of the deep and flat-MLP kernels vs twins")
        new_timing = phase9(torch, data, dev, card)
    if 10 in phases:
        banner(10, "elastic resample kernel vs plain version")
        el_err, el_timing, el_lib = phase10(torch, dev, card)
    if 11 in phases:
        banner(11, "FUSED_TAIL forward and backward kernels vs plain "
               "versions")
        tail_fwd, tail_bwd = phase11(torch, dev, card)
    if 12 in phases:
        banner(12, "per-layer path: train.main on synth_hard with "
               "FUSED_TAIL and 'method': 'pallas' (+ resume); epoch times")
        slice_launches = phase12(torch, card)
    if 13 in phases:
        banner(13, "3x3 conv kernel (forward, dx, dw) vs plain version, "
               "f32 and bf16")
        conv_err, conv_times = phase13(torch, dev, card)
    if 14 in phases:
        banner(14, "bench.py's wide model: NeuralNet + Trainer per layer, "
               "bf16, conv2 on the conv3x3 kernel; epoch times")
        wide_launches, _, _ = phase14(torch, card)
    dp_report = {}
    if phases & {15, 16, 17, 18}:
        import torch.distributed as dist
        from theanet_tpu_torch.parallel import make_mesh

        rdzv = tempfile.mkdtemp()
        dist.init_process_group("nccl", init_method=f"file://{rdzv}/rdzv",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh()
            if 15 in phases:
                banner(15, "data-parallel gradient and update kernels vs "
                       "plain versions; step-locked epochs three ways")
                dp_kernels, _ = phase15(torch, dev, card, mesh)
            if 16 in phases:
                banner(16, "data-parallel main path: Trainer(mesh) at world "
                       "1 (NCCL) and world 2 (gloo, two processes)")
                dp_launches, dp_report = phase16(torch, card, mesh)
            if 17 in phases:
                banner(17, "the ring's exchange kernel vs its plain version "
                       "in every mode; the flagship at BATCH_SZ 600 and "
                       "1024")
                ring_err, ring_times, _, ring_locked_err = phase17(
                    torch, dev, card)
            if 18 in phases:
                banner(18, "the ring main path: Trainer(mesh) at world 1 "
                       "(this process), world 2 and world 4 (processes "
                       "sharing the card through CUDA IPC)")
                ring_launches, world1, d_ranks = phase18(torch, card, mesh)
                for name, (ms, _, idle, _, _, _) in world1.items():
                    if name == "mnist_cnn":
                        print(f"  mnist_cnn at world 1: ring {min(ms):.3f} ms "
                              f"an epoch, idle {100 * idle:.1f}%; phase 5's "
                              f"epoch kernel "
                              + (f"{timing[0]:.3f} ms" if timing else
                                 "not run")
                              + "; phase 16's per-step path "
                              + ("{:.3f} ms, idle {:.1f}%".format(
                                  min(dp_report["mnist_cnn world 1"][0]),
                                  100 * dp_report["mnist_cnn world 1"][2])
                                 if dp_report else "not run"), flush=True)
        finally:
            dist.destroy_process_group()
    if 19 in phases:
        banner(19, "the deep kernel's heads and aux stages vs twin: "
               "synth_aux, galaxy_rbf's shapes under Hinge, ExpLoss, nllsq, "
               "nll90 and AuxConcat, a flat Hinge net")
        aux_err = phase19(torch, dev)
    if 20 in phases:
        banner(20, "main path: train.main on synth_aux fused (+ resume) "
               "and per layer; epoch times; a world-2 ring run")
        aux_launches, aux_times = phase20(torch, card)
    if 21 in phases:
        banner(21, "the deep kernel's conv geometry vs twin: mnist_cnn's "
               "widths with 'same' convs, a MeanLayer, a strided conv and a "
               "'full' conv over a step-locked epoch; the small geometry "
               "cases; deep_grad_step and the ring entry on mnist_same")
        geom_err, geom_dp, geom_ring_err = phase21(torch, dev, card)
    if 22 in phases:
        banner(22, "main path: train.main on synth_hard with mnist_same "
               "(+ resume); the geometry configs' epoch times; a world-2 "
               "ring run")
        geom_launches, geom_times = phase22(torch, card)
    if 23 in phases:
        banner(23, "wide heads and BATCH_SZ 3000: kernels vs twins "
               "step-locked, epoch times and head stages, the DP gradient "
               "steps; train.main at BATCH_SZ 3000 (+ resume); fused against "
               "per layer from 256 to 3000")
        head_launches, head_res, head_dp = phase23(torch, dev, card)
    if 24 in phases:
        banner(24, "the probe kernels vs their plain versions; the probe "
               "tools on the card, one launch an epoch and one a step")
        probe_launches, probe_err, probe_t, probe_tools = phase24(
            torch, dev, card)
    if 25 in phases:
        banner(25, "the GTSRB column at its published widths: deep kernel "
               "vs twin step-locked, an epoch timed; train.main on signs48")
        gtsrb_launches, gtsrb_err, gtsrb_times = phase25(torch, dev, card)
    if PARENT_PHASE in phases:
        banner(PARENT_PHASE, "the flagship library against the parent "
               "commit's, bit for bit")
        phase26(torch, data, dev, args.parent)
    if not set(ALL_PHASES) <= phases:
        print("chip_smoke: a subset of phases ran; no result", flush=True)
        return 3

    def entry(name, source, replaces, n, err, times):
        ms, plain_ms, (bound_ms, bound_by) = times
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}

    kernels = [
        entry("megastep_epoch", "theanet_tpu_torch/csrc/megastep.cu",
              "theanet_tpu/ops/megastep.py:2162", launches, step_err, timing),
        entry("deep_epoch", "theanet_tpu_torch/csrc/megastep_deep.cu",
              "theanet_tpu/ops/megastep_deep.py:1527",
              new_launches["deep_epoch"], deep_err, new_timing["deep_epoch"]),
        entry("mlp_epoch", "theanet_tpu_torch/csrc/megastep_deep.cu",
              "theanet_tpu/ops/megastep_mlp.py:167",
              new_launches["mlp_epoch"], mlp_err, new_timing["mlp_epoch"]),
    ]
    kernels += [
        entry("elastic_resample", "theanet_tpu_torch/csrc/elastic_resample.cu",
              "theanet_tpu/ops/elastic_pallas.py:34",
              slice_launches["elastic_resample"], el_err, el_timing),
        entry("fused_tail_forward", "theanet_tpu_torch/csrc/fused_mlp.cu",
              "theanet_tpu/ops/fused_mlp.py:39",
              slice_launches["tail_forward"], *tail_fwd),
        entry("fused_tail_backward", "theanet_tpu_torch/csrc/fused_mlp.cu",
              "theanet_tpu/ops/fused_mlp.py:77",
              slice_launches["tail_backward"], *tail_bwd),
    ]
    for name, what in (("conv3x3_forward", "forward"),
                       ("conv3x3_backward", "backward")):
        ms, plain_ms, bnd, lib_ms = conv_times[(what, "bfloat16")]
        kernels.append(entry(
            name, "theanet_tpu_torch/csrc/conv3x3.cu",
            "theanet_tpu/ops/conv_pallas.py:" + ("68" if what == "forward"
                                                else "87"),
            wide_launches[name], conv_err[what], (ms, plain_ms, bnd)))
        kernels[-1]["library_ms"] = lib_ms
    kernels[3]["library_ms"] = el_lib
    for name, source, line in (
            ("megastep_grad_step", "megastep.cu", "megastep_dp.py:168"),
            ("deep_grad_step", "megastep_deep.cu", "megastep_dp.py:168"),
            ("megastep_update", "megastep.cu", "megastep_dp.py:387"),
            ("deep_update", "megastep_deep.cu", "megastep_dp.py:387")):
        kernels.append(entry(name, "theanet_tpu_torch/csrc/" + source,
                             "theanet_tpu/ops/" + line, dp_launches[name],
                             *dp_kernels[name]))
    kernels.append(entry("ring_exchange", "theanet_tpu_torch/csrc/ring.cuh",
                         "theanet_tpu/ops/megastep_ring.py:180",
                         ring_launches["ring_exchange"], ring_err,
                         ring_times[:3]))
    kernels[-1]["library_ms"] = ring_times[3]
    for name, cfg, source in (
            ("megastep_ring_epoch", "mnist_cnn", "megastep.cu"),
            ("deep_ring_epoch", "galaxy_rbf", "megastep_deep.cu")):
        ms, _, _, _, ms_plain, bnd = world1[cfg]
        kernels.append(entry(name, "theanet_tpu_torch/csrc/" + source,
                             "theanet_tpu/ops/megastep_ring.py:180",
                             ring_launches[name], ring_locked_err[name],
                             (min(ms), ms_plain, bnd)))
    kernels.append(entry("deep_epoch_aux_heads",
                         "theanet_tpu_torch/csrc/megastep_deep.cu",
                         "theanet_tpu/ops/megastep_deep.py:1527",
                         aux_launches["deep_epoch"], aux_err,
                         (aux_times[0], aux_times[2], aux_times[3])))
    ms, plain_ms, bnd = geom_times["mnist_same"]
    kernels.append(entry("deep_epoch_geometry",
                         "theanet_tpu_torch/csrc/megastep_deep.cu",
                         "theanet_tpu/ops/megastep_deep.py:1527",
                         geom_launches["deep_epoch"],
                         max(geom_err, geom_dp["deep_grad_step"][0],
                             geom_ring_err), (ms, plain_ms, bnd)))
    kernels[-1]["configs"] = {
        name: {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2][0],
               "bound_by": t[2][1]} for name, t in geom_times.items()}
    kernels.append(entry("deep_epoch_gtsrb",
                         "theanet_tpu_torch/csrc/megastep_deep.cu",
                         "theanet_tpu/ops/megastep_deep.py:1527",
                         gtsrb_launches["deep_epoch"], gtsrb_err,
                         gtsrb_times))
    kernels[0]["epoch_step_locked_max_abs_err"] = epoch_err
    # phase 23's configurations under the three epoch entries, with the
    # launches of the BATCH_SZ 3000 CLI run (its own main path)
    for k, main in zip(kernels[:3], ("mnist_cnn", "galaxy_rbf",
                                     "flat_mlp")):
        k["head_us_per_step"], k["head_bound_us"] = HEAD_REPORT[main][:2]
        k["configs"] = {
            name: {"max_abs_err": err, "ms": t[0], "plain_ms": t[1],
                   "bound_ms": t[2][0], "bound_by": t[2][1],
                   "head_us_per_step": HEAD_REPORT[name][0],
                   "head_bound_us": HEAD_REPORT[name][1]}
            for name, (err, t) in head_res.get(k["name"], {}).items()}
    for k, main in zip(kernels[:3], STAGE_CONFIGS):
        k["stages_us_per_step"] = {
            kind: {"us": us, "bound_us": b_us, "bound_by": by,
                   "library_us": lib_us}
            for kind, (us, b_us, by, lib_us) in STAGE_REPORT[main].items()
            if b_us}
    kernels[0]["configs"]["crossover"] = {
        f"mnist_b{b}": {f"{path}_ms": {"median": m, "min": lo, "max": hi}
                        for path, (m, lo, hi) in t.items()}
        for b, t in head_res["crossover"].items()}
    kernels[0]["configs"]["mnist_b3000"]["launches"] = \
        head_launches["megastep_epoch"]
    kernels[0]["configs"]["dp_grad_steps"] = {
        name: {"max_abs_err": err, "ms": t[0], "plain_ms": t[1],
               "bound_ms": t[2][0], "bound_by": t[2][1]}
        for name, (err, t) in head_dp.items()}
    for name, line in (("floor_probe", "floor_probe.py:95"),
                       ("conv_section_probe", "conv_layout_probe.py:215"),
                       ("relay_probe", "conv_layout_probe.py:255")):
        ms, plain_ms, bnd, lib_ms = probe_t[name]
        kernels.append(entry(name, "theanet_tpu_torch/csrc/probes.cu",
                             "tools/" + line, probe_launches[name],
                             probe_err[name], (ms, plain_ms, bnd)))
        kernels[-1]["library_ms"] = lib_ms
    for k, tool in zip(kernels[-3:], ("floor", "section", "section")):
        k["tools_ms"] = {run: ms for run, ms in probe_tools.items()
                         if run.startswith(tool)}
    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The launch plans of the fused families' gradient and product stages
(``ops/stage_plan.py``, mirroring ``csrc/stages.cuh``) and the summation
orders they run, on the CPU.

The kernels cannot run here, so these pin what they are handed: for every
shipped ``params/*.prms``, phase 23's five configurations, chip_smoke.py's
geometry configurations and the data-parallel and ring per-rank batches
(B 5 and 10), the conv weight gradient's batch slices and row bands, the
conv input gradient's row bands and the products' K slices each cover
their range exactly once, in order; every launch fits shared memory and
CUDA's grid; conv1 at B 20 gets a block for every SM; the workspace the
mirror carves holds every plan's partials. The input gradient's plan and
its threads' staging and position walks are held over a grid of shapes
the route rule takes, wide levels included, and a net just past the
stages' shared-memory limit declines by name. Then plain PyTorch models of
the new orders (``wgrad_sliced``: batch slices and staged bands read at
the kernel's input offsets; ``dgrad_canvas``: the stride-dilated dz canvas;
``gemm_ksplit``: K slices added in order) are held to ``jax.grad`` of the
JAX package's own ConvLayer and HiddenLayer on the same seeded numpy
inputs, each output within 1e-5 of the larger of 1 and its largest value
(the bound of the twin tests).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from theanet_tpu.layers.conv import ConvLayer as JaxConv
from theanet_tpu.layers.dense import HiddenLayer as JaxHidden

from theanet_tpu_torch.model import NeuralNet as TorchNet
from theanet_tpu_torch.ops import megastep
from theanet_tpu_torch.ops import megastep_deep as td
from theanet_tpu_torch.ops import stage_plan as sp

import chip_smoke

ATOL = 1e-5
GRID_X, GRID_YZ = 2 ** 31 - 1, 65535
CONFIGS = chip_smoke.PLAN_CONFIGS
# configurations at BATCH_SZ 20 with a conv level
B20_CONV = [n for n, b in CONFIGS if b is None and n not in ("flat_mlp",
            "flat_b128_457") and chip_smoke.HEAD_SHAPES.get(n, (20,))[0] == 20]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _spec(name, batch):
    """The fused spec a config trains on, at BATCH_SZ ``batch``."""
    return chip_smoke.plan_spec(name, batch)


def _family(spec):
    """(conv levels in the order the step runs their gradients, the input-
    gradient levels, the products, the workspace floats)."""
    if isinstance(spec, megastep.MegaSpec):
        lv = sp.flagship_levels(spec)
        return (lv, lv[:1], sp.flagship_products(spec),
                sp.megastep_workspace_floats(spec))
    lv = sp.deep_levels(spec)[::-1]
    return (lv, lv[:-1], sp.deep_products(spec),
            sp.deep_workspace_floats(spec))


def _covers(ranges, n):
    """``ranges`` [(begin, end)] are non-empty and run 0..n in order."""
    pos = 0
    for b, e in ranges:
        assert b == pos and e > b
        pos = e
    assert pos == n


@pytest.mark.parametrize("name,batch", CONFIGS)
def test_plans_cover_once_in_order(name, batch):
    spec = _spec(name, batch)
    levels, dlevels, products, _ = _family(spec)
    B = spec.batch
    for g in levels:
        p = sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
        assert g.B == B and p.nout == g.F * g.F * g.Cin + 1
        _covers(p.slices(B), B)
        assert p.nsl * p.nb >= B > (p.nsl - 1) * p.nb
        _covers([(y, min(g.e, y + p.ny)) for y in range(0, g.e, p.ny)],
                g.e)
        # every output in one tap group, a warp's opw outputs at most
        assert p.ntg * sp.WG_WARPS * p.opw >= p.nout
        assert 1 <= p.opw <= sp.WG_OPW
        assert p.hb == (p.ny - 1) * g.cs + g.F
        assert p.sp == (g.e - 1) * g.cs + g.F
        # every tap of every staged position lies in the staged rows
        assert (p.ny - 1) * g.cs + g.F - 1 < p.hb
        assert 4 * p.smem_floats <= sp.SMEM_OPT_IN
        gx, gy, gz = p.grid(g.M)
        assert gx <= GRID_X and gy <= GRID_YZ and gz <= GRID_YZ
    for g in dlevels:
        p = sp.dgrad_plan(B, g.Cin, g.W, g.M, g.F)
        _covers([(i, min(g.W, i + p.rows)) for i in range(0, g.W, p.rows)],
                g.W)
        assert p.nbands == -(-g.W // p.rows)
        assert p.rows * g.W <= p.threads <= sp.DG_MAX_THREADS
        assert p.threads % 32 == 0 and p.dp == g.W + g.F - 1
        # the last output on the stride lattice lands on the canvas
        assert (g.e - 1) * g.cs + g.F - 1 - g.pad < p.dp
        assert 4 * p.smem_floats <= sp.SMEM_OPT_IN
        gx, gy, gz = p.grid(B, g.Cin)
        assert gx <= GRID_X and gy <= GRID_YZ and gz <= GRID_YZ
    for _, M, N, K in products:
        p = sp.gemm_plan(M, N, K)
        _covers(p.ranges(K), K)
        assert p.kslice % sp.GK == 0 and p.nks >= 1
        assert p.part_floats <= sp.GEMM_PART_CAP
        assert p.part_floats == (p.nks * M * N if p.nks > 1 else 0)
        assert -(-N // sp.TILE) <= GRID_X and -(-M // sp.TILE) <= GRID_YZ


@pytest.mark.parametrize("name,batch", CONFIGS)
def test_workspace_holds_every_plan(name, batch):
    """The mirror's carve reserves one weight-gradient region of slices and
    one of counters, each as large as the largest level's (the levels run
    one after another), and the products' fixed GEMM_PART_CAP partials and
    GEMM_TARGET tile counters (a split product has fewer tiles), on top of
    the carve without them."""
    spec = _spec(name, batch)
    levels, _, products, total = _family(spec)
    plans = [sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs) for g in levels]
    parts = [p.part_floats(g.M) for p, g in zip(plans, levels)]
    ctrs = [p.counters(g.M) for p, g in zip(plans, levels)]
    assert sp.stage_floats(levels) == (max(parts, default=0)
                                       + max(ctrs, default=0)
                                       + sp.GEMM_PART_CAP + sp.GEMM_TARGET)
    base = total - sp.stage_floats(levels)
    assert base > 0
    if isinstance(spec, megastep.MegaSpec):
        # megastep.cu's carve before the stage regions: the state, the
        # activations, their gradients and the head's scratch
        B = spec.batch
        assert base >= (spec.img ** 2 * (spec.in_ch * B + 2)
                        + sum(r * c for r, c in megastep.kernel_shapes(spec)))
    for _, M, N, K in products:
        p = sp.gemm_plan(M, N, K)
        if p.nks > 1:
            tiles = -(-M // sp.TILE) * -(-N // sp.TILE)
            assert tiles <= sp.GEMM_TARGET


@pytest.mark.parametrize("name,batch", CONFIGS)
def test_staging_copies_each_element_once(name, batch):
    """The staging passes as the kernels' threads walk them: k_wgrad's
    copies every element of its nbs samples (dz rows e wide, input rows sp
    wide) exactly once, for a full and a short last pass; dgrad_at's every
    element of its band's canvas exactly once, for a full and the last
    band."""
    spec = _spec(name, batch)
    levels, dlevels, _, _ = _family(spec)
    for g in levels:
        p = sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
        rows_per = p.ny + g.Cin * p.hb
        for nbt in sorted({1, p.nbs}):
            got = sp.wgrad_staging(g, p, nbt)
            want = [(bi, r, c) for bi in range(nbt) for r in range(rows_per)
                    for c in range(g.e if r < p.ny else p.sp)]
            assert sorted(got) == want
    for g in dlevels:
        p = sp.dgrad_plan(g.B, g.Cin, g.W, g.M, g.F)
        for band in sorted({0, p.nbands - 1}):
            got, n = sp.dgrad_staging(g, p, band)
            assert sorted(got) == list(range(n))


@pytest.mark.parametrize("e", [1, 5, 11, 13, 26, 30, 32, 33, 40, 70])
def test_wgrad_lanes_sum_each_position_once(e):
    """A k_wgrad warp's lanes take every staged position of a band exactly
    once, at widths below, at and past a warp (a full band and a short
    last band)."""
    for ny in sorted({e, max(1, e // 3)}):
        got = [pos for ps in sp.wgrad_positions(e, ny).values() for pos in ps]
        assert sorted(got) == [(y, x) for y in range(ny) for x in range(e)]


@pytest.mark.parametrize("name", B20_CONV)
def test_conv_stages_fill_the_card_at_b20(name):
    """At BATCH_SZ 20 conv1's weight gradient (the level with the fewest
    maps at mnist_cnn: 4 maps of 10 outputs) gets at least a block an SM;
    so does the flagship's conv2 input gradient."""
    spec = _spec(name, None)
    assert spec.batch == 20
    levels, dlevels, _, _ = _family(spec)
    g = levels[-1]
    p = sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
    assert np.prod(p.grid(g.M)) >= sp.SM_COUNT
    if isinstance(spec, megastep.MegaSpec):
        g = dlevels[0]
        d = sp.dgrad_plan(g.B, g.Cin, g.W, g.M, g.F)
        assert np.prod(d.grid(g.B, g.Cin)) >= sp.SM_COUNT


def test_flagship_plans_at_mnist_cnn():
    """The plans at mnist_cnn's shapes, as PERF.md quotes them."""
    spec = _spec("mnist_cnn", None)
    g2, g1 = sp.flagship_levels(spec)
    p1 = sp.wgrad_plan(g1.B, g1.M, g1.Cin, g1.F, g1.e, g1.cs)
    p2 = sp.wgrad_plan(g2.B, g2.M, g2.Cin, g2.F, g2.e, g2.cs)
    assert (p1.nsl, p1.nb, p1.ntg, p1.opw, p1.ny) == (20, 1, 2, 1, 26)
    assert (p2.nsl, p2.nb, p2.ntg, p2.opw) == (10, 2, 2, 3)
    d = sp.dgrad_plan(20, 4, 13, 20, 3)
    assert (d.nbands, d.rows, d.threads) == (4, 4, 256)
    assert sp.gemm_plan(20, 500, 720)[:2] == (6, 128)    # z3
    assert sp.gemm_plan(20, 720, 500)[:2] == (4, 128)    # df
    assert sp.gemm_plan(720, 500, 20)[:2] == (1, 64)     # dwh
    # long batches keep one slice: the tiles fill the card
    assert sp.gemm_plan(3000, 500, 720).nks == 1


def test_long_batch_slices_stay_short():
    """B 3000: conv1's weight gradient cuts the batch into hundreds of
    slices of a few samples (not 40 blocks of 2 M terms)."""
    spec = _spec("mnist_b3000", None)
    g = sp.flagship_levels(spec)[1]
    p = sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
    assert p.nb * g.e * g.e <= 2 * sp.WG_SLICE_TERMS
    assert p.nsl >= 300


# (B, Cin, W, M, F) of the input gradient's wide forms: one row a band
# with the canvas wider than the block (dp > threads; a level 256 wide at
# 12 maps and filter 3 is a 514 px flagship's conv2), and a band wider than
# DG_MAX_THREADS (a thread several positions)
DGRAD_WIDE = {
    "w256-m12": (20, 4, 256, 12, 3),
    "w256-m20-f2": (20, 4, 256, 20, 2),
    "w510-m12-f5": (20, 4, 510, 12, 5),
    "w544-m6-f5": (20, 20, 544, 6, 5),
    "w1024-m3": (4, 2, 1024, 3, 3),
    "w1030-m2": (4, 2, 1030, 2, 3),
    "w1100-m1-f5": (1, 1, 1100, 1, 5),
}


@pytest.mark.parametrize("name", DGRAD_WIDE)
def test_dgrad_walks_wide_levels_once(name):
    """At the wide forms every canvas element of a full and the last band
    is staged exactly once and every position summed by exactly one
    thread: the staging steps its column chunks and the sum its positions,
    so no shape leaves shared memory unwritten or a position unsummed."""
    B, cin, W, M, F = DGRAD_WIDE[name]
    g = sp.ConvGeom(B, M, cin, F, W - F + 1, W - F + 1, 1, 0, W)
    p = sp.dgrad_plan(B, cin, W, M, F)
    assert p.dp > p.threads or p.rows * W > p.threads
    for band in sorted({0, p.nbands - 1}):
        got, n = sp.dgrad_staging(g, p, band)
        assert sorted(got) == list(range(n))
        pos = [q for qs in sp.dgrad_positions(g, p, band).values()
               for q in qs]
        i0 = band * p.rows
        assert sorted(pos) == [(i, j) for i in range(i0, min(W, i0 + p.rows))
                               for j in range(W)]


DGRAD_GRID = [(B, cin, W, M, F)
              for B in (1, 5, 20, 3000) for cin in (1, 4, 20, 64)
              for W in list(range(1, 1200, 13)) + [256, 512, 1024, 1025]
              for M in (1, 6, 12, 20, 64) for F in (2, 3, 5)
              if W >= F]


def test_dgrad_plans_over_a_grid():
    """Over a grid of levels (widths 1 to 1196 and the powers of two, maps
    1 to 64, filters 2 to 5, batches 1 to 3000) whose staging the route
    rule admits, the input gradient's plan launches a legal block (a warp
    multiple, 256 to 1024 threads) whose staging walk has a row step of at
    least one, bands that tile the input, and a canvas that takes every
    tap; a level it does not admit needs more than a block's shared memory
    even at one row a band."""
    n_ok = n_past = 0
    for B, cin, W, M, F in DGRAD_GRID:
        p = sp.dgrad_plan(B, cin, W, M, F)
        if 4 * p.smem_floats > sp.SMEM_OPT_IN:
            assert p.rows == 1
            n_past += 1
            continue
        n_ok += 1
        assert p.threads % 32 == 0
        assert sp.DG_MIN_THREADS <= p.threads <= sp.DG_MAX_THREADS
        assert p.threads // min(p.dp, p.threads) >= 1
        assert p.dp == W + F - 1
        assert (p.nbands - 1) * p.rows < W <= p.nbands * p.rows
        assert p.rows * W <= p.threads or p.rows == 1
        assert p.smem_floats == M * F * F + M * (p.rows + F - 1) * p.dp
        assert p.nbands <= GRID_X
    assert n_ok > 10000 and n_past > 0   # the grid reaches past the limit


WGRAD_GRID = [(B, M, cin, F, e, cs)
              for B in (1, 5, 20, 3000) for M in (1, 4, 20, 64)
              for cin in (1, 3, 20, 64) for F in (2, 3, 5)
              for e in list(range(1, 700, 11)) + [256, 300] for cs in (1, 2)]


def test_wgrad_plans_over_a_grid():
    """Over a grid of levels the weight gradient's plan covers the batch
    with its slices and every output with its tap groups (at most WG_OPW a
    warp); a level it does not admit needs more than a block's shared
    memory even at one output row a band. The staging walk of a level
    wider than the block (sp > WG_THREADS: several column chunks) copies
    each element once."""
    n_ok = n_past = 0
    for B, M, cin, F, e, cs in WGRAD_GRID:
        p = sp.wgrad_plan(B, M, cin, F, e, cs)
        if 4 * p.smem_floats > sp.SMEM_OPT_IN:
            assert p.ny == 1
            n_past += 1
            continue
        n_ok += 1
        assert (p.nsl - 1) * p.nb < B <= p.nsl * p.nb
        assert p.ntg * sp.WG_WARPS * p.opw >= p.nout and p.opw <= sp.WG_OPW
        assert 1 <= p.nbs <= p.nb and 1 <= p.ny <= e
        assert p.nsl <= GRID_YZ and M <= GRID_YZ
    assert n_ok > 10000 and n_past > 0   # the grid reaches past the limit
    g = sp.ConvGeom(3, 2, 2, 3, 300, 300, 1, 0, 302)
    p = sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
    assert p.sp > sp.WG_THREADS
    got = sp.wgrad_staging(g, p, p.nbs)
    rows_per = p.ny + g.Cin * p.hb
    assert sorted(got) == [(bi, r, c) for bi in range(p.nbs)
                           for r in range(rows_per)
                           for c in range(g.e if r < p.ny else p.sp)]


def _wide_net(cin, maps, filt, side, pool=2):
    """A deep net whose level 1 (``cin`` input maps, ``maps`` maps of
    filter ``filt``) reads a ``side`` x ``side`` input: level 0 is a
    ``cin``-map 5x5 valid conv of a (side + 4) px image with no pool."""
    conv = [["ConvLayer", {"num_maps": n, "filter_sz": f, "stride": 1,
                           "actvn": "relu"}] for n, f in ((cin, 5),
                                                          (maps, filt))]
    return TorchNet([["InputLayer", {"img_sz": side + 4}], conv[0],
                     conv[1], ["PoolLayer", {"pool_sz": pool}],
                     ["HiddenLayer", {"n_out": 8}],
                     ["SoftmaxLayer", {"n_out": 4}]],
                    {"SEED": 1, "BATCH_SZ": 4})


@pytest.mark.parametrize("cin,maps,filt,side,kind", [
    (64, 4, 5, 176, None), (64, 4, 5, 178, "weight-gradient"),
    (1, 64, 5, 172, None), (1, 64, 5, 173, "input-gradient"),
], ids=["wgrad-fits", "wgrad-past", "dgrad-fits", "dgrad-past"])
def test_stage_smem_limit_declines_by_name(cin, maps, filt, side, kind):
    """A net whose level 1 stages just inside a block's shared memory at
    one row a band fuses in the deep family; one just past it declines,
    naming the stage, instead of raising at its first epoch."""
    net = _wide_net(cin, maps, filt, side)
    got = megastep.fused_decline_reason(net)
    plan = megastep.fused_plan(net)
    if kind is None:
        assert got is None and plan.epoch_fn is td.deep_epoch, got
        return
    assert plan is None
    assert f"{kind} stage" in got and "opt in to" in got, got


# ---------------------------------------------------- the orders against JAX

# (B, Cin, W, M, F, stride, mode, e_cut): e_cut > 0 drops that many
# trailing output rows and columns from the pools' windows (ignore_border)
CONV_CASES = {
    "valid": (3, 2, 9, 3, 3, 1, "valid", 0),
    "valid-ib": (3, 2, 10, 3, 3, 1, "valid", 1),
    "same": (2, 3, 8, 2, 3, 1, "same", 0),
    "same-5": (2, 2, 9, 3, 5, 1, "same", 0),
    "full": (2, 2, 7, 3, 3, 1, "full", 0),
    "stride2": (3, 2, 14, 3, 3, 2, "valid", 0),
    "b1": (1, 3, 8, 4, 3, 1, "valid", 0),
    "b302-ragged-slices": (302, 3, 12, 8, 3, 1, "valid", 0),
}


def _jax_conv_grads(x, w, b, dz, stride, mode):
    """(dw (M, Cin, F, F), db, dx) of sum(conv(x) * dz) by jax.grad of the
    JAX package's ConvLayer (linear activation)."""
    B, cin, W, _ = x.shape
    M, _, F, _ = w.shape
    lyr = JaxConv([w, b], None, B, cin, W, M, F, stride, mode=mode,
                  actvn="linear")

    def loss(w_, b_, x_):
        out = lyr.apply((w_, b_), x_, key=None, train=False)
        return jnp.sum(out * dz)

    return [np.asarray(a) for a in
            jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(w), jnp.asarray(b),
                                              jnp.asarray(x))]


def _geom(B, cin, W, M, F, stride, mode, e_cut):
    pad = {"valid": 0, "same": F // 2, "full": F - 1}[mode]
    both = {"valid": 0, "same": F - 1, "full": 2 * (F - 1)}[mode]
    c = (W + both - F + 1) // stride
    return sp.ConvGeom(B, M, cin, F, c, c - e_cut, stride, pad, W)


def _conv_case(name, seed=0):
    B, cin, W, M, F, stride, mode, e_cut = CONV_CASES[name]
    g = _geom(B, cin, W, M, F, stride, mode, e_cut)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, cin, W, W)).astype(np.float32)
    w = (rng.standard_normal((M, cin, F, F)) / F).astype(np.float32)
    b = rng.standard_normal(M).astype(np.float32)
    dz = rng.standard_normal((B, M, g.c, g.c)).astype(np.float32)
    dz[:, :, g.e:] = 0.0   # outside the pools' windows: no gradient
    dz[:, :, :, g.e:] = 0.0
    return g, x, w, b, dz


def _close(got, want):
    want = np.asarray(want)
    bound = ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=bound)


def wgrad_sliced(dz, x, g, plan=None):
    """A conv level's weight and bias gradients (kernel layout (M, F*F*Cin)
    and (M,)) as k_wgrad computes them: per batch slice
    of ``plan`` and band of its output rows, the band's dz and the zero-
    padded input rows under it staged as the kernel stages them, each
    output's sum over the band read at the kernel's input offsets;
    then the slices added in slice order (the last block of each tap
    group and map adds them). ``dz`` (B, M, c, c), ``x`` (B,
    Cin, W, W), ``g`` the level's ConvGeom."""
    p = plan or sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
    e, cs, F, sp = g.e, g.cs, g.F, p.sp
    o = torch.arange(p.nout - 1)
    ci, u, v = o % g.Cin, (o // g.Cin) // F, (o // g.Cin) % F
    ooff = ci * p.hb * sp + (F - 1 - u) * sp + (F - 1 - v)
    q = torch.arange(p.ny * e)
    qoff = (q // e) * cs * sp + (q % e) * cs
    xp = torch.zeros((g.B, g.Cin, max(g.W + 2 * g.pad, (e - 1) * cs + F + g.pad)
                      + p.hb, sp + g.W), dtype=x.dtype)
    xp[:, :, g.pad:g.pad + g.W, g.pad:g.pad + g.W] = x
    part = torch.zeros((p.nsl, g.M, p.nout), dtype=dz.dtype)
    for s, (b0, b1) in enumerate(p.slices(g.B)):
        for b in range(b0, b1):
            for y0 in range(0, e, p.ny):
                ny = min(p.ny, e - y0)
                hb, nq = (ny - 1) * cs + F, ny * e
                dzs = dz[b, :, y0:y0 + ny, :e].reshape(g.M, nq)
                ins = torch.zeros((g.Cin, p.hb, sp), dtype=x.dtype)
                r0 = y0 * cs   # canvas row of padded-input row y0*cs - pad
                ins[:, :hb] = xp[b, :, r0:r0 + hb, :sp]
                taps = ins.reshape(-1)[qoff[:nq, None] + ooff[None, :]]
                part[s, :, :-1] += dzs @ taps
                part[s, :, -1] += dzs.sum(1)
    total = part[0].clone()
    for s in range(1, p.nsl):
        total = total + part[s]
    return total[:, :-1], total[:, -1]


def dgrad_canvas(dz, w_k, g, plan=None):
    """A conv level's input gradient (B, Cin, W, W) as k_conv_dgrad (and
    the flagship's k_conv2_dgrad_pool1_bwd) computes it: per (band, input
    map, sample) the weights w[m, u, v, ci] and the sample's dz dilated by
    the stride onto the zero canvas (dzd[m][Y][X] = dz[m][y][x] at Y =
    y*cs + F-1-pad, y < e), each position's taps dzd[m][i+u][j+v] summed
    over m, u, v. ``w_k`` the kernel-layout weights (M, F*F*Cin)."""
    p = plan or sp.dgrad_plan(g.B, g.Cin, g.W, g.M, g.F)
    F, off, cs = g.F, g.F - 1 - g.pad, g.cs
    canvas = torch.zeros((g.B, g.M, p.dp + F, p.dp + F), dtype=dz.dtype)
    ys = torch.arange(g.e) * cs + off
    keep = ys < p.dp
    ys = ys[keep]
    canvas[:, :, ys[:, None], ys[None, :]] = dz[:, :, :g.e, :g.e][
        :, :, keep][:, :, :, keep]
    canvas = canvas[:, :, :p.dp, :p.dp]
    w = w_k.reshape(g.M, F, F, g.Cin)
    din = torch.zeros((g.B, g.Cin, g.W, g.W), dtype=dz.dtype)
    for i0 in range(0, g.W, p.rows):
        nr = min(p.rows, g.W - i0)
        band = canvas[:, :, i0:i0 + nr + F - 1]
        for u in range(F):
            for v in range(F):
                din[:, :, i0:i0 + nr] += torch.einsum(
                    "bmij,mc->bcij", band[:, :, u:u + nr, v:v + g.W],
                    w[:, u, v, :])
    return din


def gemm_ksplit(A, B, plan=None):
    """A @ B as gemm computes it: each of ``plan``'s K slices' product,
    then the slices added in slice order."""
    p = plan or sp.gemm_plan(A.shape[0], B.shape[1], A.shape[1])
    out = None
    for kb, ke in p.ranges(A.shape[1]):
        part = A[:, kb:ke] @ B[kb:ke]
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("name", CONV_CASES)
def test_wgrad_slices_match_jax(name):
    g, x, w, b, dz = _conv_case(name)
    dw, db, _ = _jax_conv_grads(x, w, b, dz, g.cs,
                                CONV_CASES[name][6])
    p = sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
    if name == "b302-ragged-slices":
        assert p.nb > 1 and g.B % p.nb != 0   # the last slice is short
    got_w, got_b = wgrad_sliced(torch.from_numpy(dz), torch.from_numpy(x),
                                   g, p)
    # kernel layout: dw_k[m, (u*F+v)*Cin + c] = dw[m, c, u, v]
    _close(got_w, dw.transpose(0, 2, 3, 1).reshape(g.M, -1))
    _close(got_b, db)


@pytest.mark.parametrize("ny", [1, 2, 3])
def test_wgrad_bands_match_jax(ny):
    """A plan with fewer staged rows than the level has (the form a wide
    level takes to fit 48 KB) gives the same sums."""
    g, x, w, b, dz = _conv_case("stride2")
    dw, db, _ = _jax_conv_grads(x, w, b, dz, g.cs, "valid")
    p = sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
    p = p._replace(ny=ny, hb=(ny - 1) * g.cs + g.F)
    got_w, got_b = wgrad_sliced(torch.from_numpy(dz), torch.from_numpy(x),
                                   g, p)
    _close(got_w, dw.transpose(0, 2, 3, 1).reshape(g.M, -1))
    _close(got_b, db)


@pytest.mark.parametrize("name", CONV_CASES)
def test_dgrad_canvas_matches_jax(name):
    g, x, w, b, dz = _conv_case(name, seed=1)
    _, _, dx = _jax_conv_grads(x, w, b, dz, g.cs, CONV_CASES[name][6])
    w_k = torch.from_numpy(w.transpose(0, 2, 3, 1).reshape(g.M, -1).copy())
    p = sp.dgrad_plan(g.B, g.Cin, g.W, g.M, g.F)
    _close(dgrad_canvas(torch.from_numpy(dz), w_k, g, p), dx)
    one_band = p._replace(rows=g.W, nbands=1)
    _close(dgrad_canvas(torch.from_numpy(dz), w_k, g, one_band), dx)


# (B, K in, N out): K cut into several slices, the last short; B 1
DENSE_CASES = {"b5": (5, 150, 40), "b1": (1, 200, 24), "b20-k720": (20, 720,
                                                                    50)}


@pytest.mark.parametrize("name", DENSE_CASES)
def test_ksplit_products_match_jax(name):
    """The forward (x W + b), the weight gradient (x^T g) and the input
    gradient (g W^T) of a dense layer in gemm's K slices against jax.grad
    of the JAX package's HiddenLayer (linear activation)."""
    B, K, N = DENSE_CASES[name]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, K)).astype(np.float32)
    W = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    gz = rng.standard_normal((B, N)).astype(np.float32)
    lyr = JaxHidden([W, bias], None, K, N, actvn="linear")
    z = np.asarray(lyr.linear((jnp.asarray(W), jnp.asarray(bias)),
                              jnp.asarray(x)))
    gW, gx = jax.grad(lambda W_, x_: jnp.sum(
        lyr.linear((W_, jnp.asarray(bias)), x_) * gz), argnums=(0, 1))(
        jnp.asarray(W), jnp.asarray(x))
    xt, Wt, gt = map(torch.from_numpy, (x, W, gz))
    fwd = sp.gemm_plan(B, N, K)
    assert fwd.nks > 1
    _close(gemm_ksplit(xt, Wt, fwd) + torch.from_numpy(bias), z)
    _close(gemm_ksplit(xt.T, gt), gW)
    _close(gemm_ksplit(gt, Wt.T), gx)

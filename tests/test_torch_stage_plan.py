"""The launch plans of the fused families' gradient and product stages
(``ops/stage_plan.py``, mirroring ``csrc/stages.cuh``) and the summation
orders they run, on the CPU.

The kernels cannot run here, so these pin what they are handed: for every
shipped ``params/*.prms``, phase 23's five configurations, chip_smoke.py's
geometry configurations and the data-parallel and ring per-rank batches
(B 5 and 10), the conv weight gradient's slices of (sample, band) units
and its map groups, the conv input gradient's row bands and the products'
K slices each cover their range exactly once, in order; every launch fits
shared memory and CUDA's grid; the weight gradient's slices fill the card
at B 20 in one wave; the workspace the mirror carves holds every plan's
partials. Both gradients' plans and their threads' staging and position
walks are held over grids of shapes the route rule takes, wide levels
included (the weight gradient's admitting every level the batch-slice
plan before it admitted), and a net just past the stages' shared-memory
limit declines by name. Then plain PyTorch models of the new orders
(``wgrad_clustered``: slices of units staged at the kernel's shared-memory
offsets, their sums added by clusters; ``dgrad_canvas``: the
stride-dilated dz canvas; ``gemm_ksplit``: K slices added in order) are
held to ``jax.grad`` of the JAX package's own ConvLayer and HiddenLayer on
the same seeded numpy inputs, each output within 1e-5 of the larger of 1
and its largest value (the bound of the twin tests); the weight
gradient's at every conv level of every configuration here too.
The deep family's tiled input gradient (``dgrad_tile_plan``, a wide
level's register-tiled implicit GEMM) has its own: its walk over a grid of
levels (each output summed by one thread, every shared read staged
first), which levels take it (the GTSRB column's two; no level of any
other configuration), its launch counter, and its order model
``dgrad_tiled`` against ``jax.grad`` at every conv case and at the
column's levels.
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


def _wgrad_plan_sound(g, p):
    """The weight gradient's plan at level ``g``: its units (a sample's
    band) cover the batch's rows once in order, slices cover the units,
    map groups the maps, clusters the slices; a round of staged units fits
    the block's shared memory and holds every tap of its positions; the
    block's thread tiles cover the group's outputs, each tile's position
    groups a power of two; the grid fits CUDA's."""
    B, e = g.B, g.e
    _covers([(y, min(e, y + p.ny)) for y in range(0, e, p.ny)], e)
    assert p.nbn == -(-e // p.ny)
    _covers(p.units(B), B * p.nbn)
    assert p.nsl * p.nu >= B * p.nbn > (p.nsl - 1) * p.nu
    assert (p.ngr - 1) * p.mg < g.M <= p.ngr * p.mg
    assert 1 <= p.cl <= sp.WG_CLUSTER and p.nslp % p.cl == 0
    assert 0 <= p.nslp - p.nsl < p.cl
    # one wave: a block an SM at most (each holds an SM's registers)
    assert p.nslp * p.ngr <= sp.SM_COUNT or p.ngr > sp.SM_COUNT
    assert 1 <= p.nbs <= p.nu and (p.nbs == 1 or p.nbn == 1)
    assert p.hb == (p.ny - 1) * g.cs + g.F
    assert p.sp == (e - 1) * g.cs + g.F
    # every tap of every staged position lies in the staged rows and columns
    assert (p.ny - 1) * g.cs + g.F - 1 < p.hb
    assert (e - 1) * g.cs + g.F - 1 < p.sp
    unit = sp.wgrad_unit_floats(p.ny, p.mg, e, g.Cin, g.F, g.cs)
    # the slice's sums and the warps' over the staged rows, in one pass
    assert p.passes == -(-p.tiles // (p.threads // p.npg))
    assert p.smem_floats == max(p.nbs * unit, p.threads if p.passes > 1
                                else p.mg * p.nout + p.threads)
    assert 4 * p.smem_floats <= sp.SMEM_OPT_IN
    assert p.tiles == -(-p.mg // sp.WG_TM) * -(-p.nout // sp.WG_TV)
    assert p.npg & (p.npg - 1) == 0
    assert p.threads % 32 == 0 and 32 <= p.threads <= sp.WG_MAX_THREADS
    assert p.tiles * p.npg <= p.threads or (p.npg == 1 and p.passes > 1)
    assert sp.WG_TM * sp.WG_TV == 32   # the cross-warp sum: a lane an output
    gx, gy = p.grid()
    assert gx <= GRID_X and gy <= GRID_YZ


@pytest.mark.parametrize("name,batch", CONFIGS)
def test_plans_cover_once_in_order(name, batch):
    spec = _spec(name, batch)
    levels, dlevels, products, _ = _family(spec)
    B = spec.batch
    for g in levels:
        p = sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
        assert g.B == B and p.nout == g.F * g.F * g.Cin + 1
        _wgrad_plan_sound(g, p)
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
    """The mirror's carve reserves one weight-gradient region of partial
    sums and one of counters, each as large as the largest level's on the
    path it takes (the levels run one after another), and the products' fixed GEMM_PART_CAP partials and
    GEMM_TARGET tile counters (a split product has fewer tiles), on top of
    the carve without them."""
    spec = _spec(name, batch)
    levels, _, products, total = _family(spec)
    parts, ctrs = [], []
    for g in levels:
        t = sp.wgrad_tile_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
        if t.tiled:
            # the clusters' sums of every tile where a tile has several
            # clusters; a counter a (tile, cluster rank) then
            several = t.ncl > 1
            assert t.part_floats() == (t.ncl * t.tiles * t.bm * t.bn
                                       if several else 0)
            assert t.counters() == (t.tiles * t.cl if several else 0)
            parts.append(t.part_floats())
            ctrs.append(t.counters())
            continue
        p = sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
        # the clusters' sums where there are several, the slices' past one
        # pass; a counter a (map group, cluster rank)
        ncl = p.nslp // p.cl
        assert p.part_floats(g.M) == ((ncl if ncl > 1 else 0) + (
            p.nslp if p.passes > 1 else 0)) * g.M * p.nout
        assert p.counters() == p.ngr * p.cl
        parts.append(p.part_floats(g.M))
        ctrs.append(p.counters())
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
    copies every element of its round's units (dz rows e wide of the
    group's maps, input rows sp wide) exactly once, for the first round
    and the last slice's last round (a short band, fewer units), in the
    first map group and the last; dgrad_at's every element of its band's
    canvas exactly once, for a full and the last band."""
    spec = _spec(name, batch)
    levels, dlevels, _, _ = _family(spec)
    for g in levels:
        p = sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
        _wgrad_walks_once(g, p)
    for g in dlevels:
        p = sp.dgrad_plan(g.B, g.Cin, g.W, g.M, g.F)
        for band in sorted({0, p.nbands - 1}):
            got, n = sp.dgrad_staging(g, p, band)
            assert sorted(got) == list(range(n))


def _wgrad_walks_once(g, p):
    """k_wgrad's staging walk of the first round and of the last slice's
    last round, in the first and the last map group, copies each element
    once; each round's positions are summed once by the position groups."""
    last = p.rounds(g.B, p.nsl - 1, g.e)[-1]
    for _, _, ny, nbt in {p.rounds(g.B, 0, g.e)[0], last}:
        hb = (ny - 1) * g.cs + g.F
        for mgc in sorted({p.mg, g.M - (p.ngr - 1) * p.mg}):
            got = sp.wgrad_staging(g, p, mgc, nbt, ny)
            assert sorted(got["dz"]) == [
                (u, m, y, x) for u in range(nbt) for m in range(mgc)
                for y in range(ny) for x in range(g.e)]
            assert sorted(got["in"]) == [
                (u, c, h, x) for u in range(nbt) for c in range(g.Cin)
                for h in range(hb) for x in range(p.sp)]
        pos = [q for qs in sp.wgrad_positions(g.e, ny, nbt, p.npg).values()
               for q in qs]
        assert sorted(pos) == [(u, y, x) for u in range(nbt)
                               for y in range(ny) for x in range(g.e)]


@pytest.mark.parametrize("e", [1, 5, 11, 13, 26, 30, 32, 33, 40, 70])
def test_wgrad_lanes_sum_each_position_once(e):
    """A k_wgrad tile's position groups take every staged position of a
    round exactly once, at widths below, at and past a warp (a full band
    and a short last band, one unit and several, any number of groups)."""
    for ny in sorted({e, max(1, e // 3)}):
        for nbt in (1, 3):
            for npg in (1, 8, 32, 128, 512):
                got = [q for qs in sp.wgrad_positions(e, ny, nbt, npg)
                       .values() for q in qs]
                assert sorted(got) == [(u, y, x) for u in range(nbt)
                                       for y in range(ny) for x in range(e)]


@pytest.mark.parametrize("name", B20_CONV)
def test_conv_stages_fill_the_card_at_b20(name):
    """At BATCH_SZ 20 every level's weight gradient spreads over the card
    in one wave: at most a block an SM (a block holds an SM's registers),
    and at least half of WG_TARGET slices (or a slice an output row of the
    batch, where it has fewer rows); the flagship's conv2 input gradient
    takes at least a block an SM."""
    spec = _spec(name, None)
    assert spec.batch == 20
    levels, dlevels, _, _ = _family(spec)
    for g in levels:
        p = sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
        assert p.nsl >= min(sp.WG_TARGET // 2, g.B * g.e)
        assert np.prod(p.grid()) <= sp.SM_COUNT
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
    # conv1: 100 bands of 6 rows in 13 clusters, 2 tiles of 128 groups
    assert (p1.ny, p1.nsl, p1.nslp, p1.cl, p1.mg) == (6, 100, 104, 8, 4)
    assert (p1.tiles, p1.npg, p1.threads, p1.passes) == (2, 128, 256, 1)
    # conv2: 80 bands of 3 rows, all 20 maps x 37 outputs a block
    assert (p2.ny, p2.nsl, p2.nslp, p2.mg, p2.ngr) == (3, 80, 80, 20, 1)
    assert (p2.tiles, p2.npg, p2.threads, p2.passes) == (25, 8, 224, 1)
    # batch 256: 86 slices of 3 whole samples, staged together
    q1 = sp.wgrad_plan(256, 4, 1, 3, 26, 1)
    q2 = sp.wgrad_plan(256, 20, 4, 3, 11, 1)
    assert (q1.nu, q1.nbs, q1.nsl, q2.nu, q2.nbs, q2.nsl) == (3, 3, 86, 3,
                                                              3, 86)
    d = sp.dgrad_plan(20, 4, 13, 20, 3)
    assert (d.nbands, d.rows, d.threads) == (4, 4, 256)
    assert sp.gemm_plan(20, 500, 720)[:2] == (6, 128)    # z3
    assert sp.gemm_plan(20, 720, 500)[:2] == (4, 128)    # df
    assert sp.gemm_plan(720, 500, 20)[:2] == (1, 64)     # dwh
    # long batches keep one slice: the tiles fill the card
    assert sp.gemm_plan(3000, 500, 720).nks == 1


def test_long_batch_slices_stay_short():
    """B 3000: each level's weight gradient takes about WG_TARGET slices
    in one wave (not thousands of slices, whose sums would cost more than
    their terms), each a run of whole samples staged several at a time."""
    spec = _spec("mnist_b3000", None)
    for g in sp.flagship_levels(spec):
        p = sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
        assert p.nbn == 1 and p.nbs >= 2 and p.nu == -(-g.B // p.nsl)
        assert sp.WG_TARGET <= p.nsl <= p.nslp * p.ngr <= sp.SM_COUNT


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


# (B, Cin, W, M, F) of the tiled input gradient's walk: batches 1 to 3000,
# input maps 1 to 256, maps 1 to 256, widths 1 to 1100, filters 2 to 7
DGRAD_TILE_GRID = [(B, cin, W, M, F)
                   for B in (1, 20, 3000) for cin in (1, 32, 100, 150, 256)
                   for W in (1, 2, 5, 9, 21, 48, 100, 333, 1100)
                   for M in (1, 7, 150, 256) for F in range(2, 8)]


def _tile_walk_sound(g, p):
    """The tiled plan ``p`` at level ``g``: a legal grid and block; the
    threads' (group, row, column tile) places distinct, so with the tiles
    and bands every output (input map, row, column) is summed by exactly
    one thread; in the first and the last chunk every weight and canvas
    element of the buffer is copied exactly once by the staging walk, and
    every shared read of the sums lies inside what was copied; the four
    buffers within what a block can opt in to."""
    F, FF, hb = g.F, g.F * g.F, p.rows + g.F - 1
    assert p.tiled == 1 and p.cit == sp.DT_TCI * p.g
    assert 1 <= p.g <= sp.DT_MAX_G and p.cit <= 32
    assert (p.nct - 1) * p.cit < g.Cin <= p.nct * p.cit
    assert (p.nbands - 1) * p.rows < g.W <= p.nbands * p.rows
    assert (p.nj - 1) * sp.DT_TJ < g.W <= p.nj * sp.DT_TJ
    assert p.dpp == p.nj * sp.DT_TJ + F - 1 >= g.W + F - 1
    assert (p.nch - 1) * p.km < g.M <= p.nch * p.km <= g.M + p.km - 1
    assert p.threads % 32 == 0 and p.threads <= sp.DT_MAX_THREADS
    assert p.g * p.rows * p.nj <= p.threads < p.g * p.rows * p.nj + 32
    assert p.smem_floats == 2 * p.km * (FF * p.cit + hb * p.dpp)
    assert 4 * p.smem_floats <= sp.SMEM_OPT_IN
    gx, gy, gz = p.grid(g.B)
    assert gx <= GRID_X and gy <= GRID_YZ and gz <= GRID_YZ
    pos = sp.dgrad_tile_positions(g, p)
    assert len(set(pos.values())) == len(pos) == p.g * p.rows * p.nj
    assert {q for q in pos.values()} == {
        (a, r, j) for a in range(p.g) for r in range(p.rows)
        for j in range(p.nj)}
    groups, rows, tiles = (np.array(v) for v in zip(*pos.values()))
    for ch in sorted({0, p.nch - 1}):
        kmc = min(p.km, g.M - ch * p.km)
        ws, cv = sp.dgrad_tile_staging(g, p, ch)
        assert (ws[:, 0] < p.threads).all() and (cv[:, 0] < p.threads).all()
        for got, n in ((ws[:, 1], kmc * FF * p.cit),
                       (cv[:, 1], kmc * hb * p.dpp)):
            assert len(got) == n
            assert (np.bincount(got, minlength=n) == 1).all()
        # the largest reads: the chunk's last map, last tap, last column
        w_hi = ((kmc - 1) * FF * p.cit + (FF - 1) * p.cit
                + groups.max() * sp.DT_TCI + sp.DT_TCI - 1)
        c_hi = (((kmc - 1) * hb + rows.max() + F - 1) * p.dpp
                + tiles.max() * sp.DT_TJ + sp.DT_TJ + F - 2)
        assert w_hi < kmc * FF * p.cit and c_hi < kmc * hb * p.dpp


def test_dgrad_tile_walks_over_a_grid():
    """Over a grid of levels (batches 1 to 3000, 1 to 256 input maps and
    maps, widths 1 to 1100, filters 2 to 7) the tiled input gradient's
    plan, whichever path the level takes, sums every output once and
    reads only what its staging wrote, inside a block's shared memory
    (_tile_walk_sound); the plan takes the tiled path exactly at Cin >=
    DT_MIN_CIN, and fills the card wherever a grid of tiles can."""
    n_tiled = 0
    for B, cin, W, M, F in DGRAD_TILE_GRID:
        g = sp.ConvGeom(B, M, cin, F, W, W, 1, F - 1, W)
        p = sp.dgrad_tile_shape(B, cin, W, M, F)
        _tile_walk_sound(g, p)
        most = B * -(-cin // sp.DT_TCI) * W   # a tile a group and row
        if most >= sp.SM_COUNT:
            assert p.nbands * p.nct * B >= sp.SM_COUNT
        q = sp.dgrad_tile_plan(B, cin, W, M, F)
        assert q == (p if cin >= sp.DT_MIN_CIN else
                     sp.DgradTilePlan(*[0] * 12))
        n_tiled += q.tiled
    assert n_tiled == len(DGRAD_TILE_GRID) * 4 // 5   # Cin 32 and up


COLUMN_LEVELS = {"level2": (100, 21, 150, 4), "level3": (150, 9, 250, 4)}


def test_dgrad_paths_by_shape():
    """The GTSRB column's two input-gradient levels take the tiled path at
    every batch the configurations run, filling the card at B 20; every
    input-gradient level of every other configuration here (mnist_cnn,
    galaxy_rbf, synth_aux, flat_mlp, the geometry, head and per-rank
    configurations) keeps the band path; a tiled launch a wide level a
    step."""
    col = _spec(chip_smoke.GTSRB, None)
    tiled = sp.dgrad_tiled_levels(col)
    assert [(g.Cin, g.W, g.M, g.F) for g in tiled] == list(
        COLUMN_LEVELS.values())
    assert tiled == sp.deep_levels(col)[1:]
    for g in tiled:
        p = sp.dgrad_tile_plan(g.B, g.Cin, g.W, g.M, g.F)
        assert g.B == 20 and np.prod(p.grid(g.B)) >= sp.SM_COUNT
    for cin, W, M, F in COLUMN_LEVELS.values():
        for B in (1, 2, 5, 10, 20, 256, 3000):
            assert sp.dgrad_tile_plan(B, cin, W, M, F).tiled
    names = {n for n, _ in CONFIGS} - {chip_smoke.GTSRB}
    assert {"mnist_cnn", "galaxy_rbf", "synth_aux", "flat_mlp"} <= names
    assert set(chip_smoke.GEOM_CONFIGS) <= names
    for name, batch in CONFIGS:
        if name == chip_smoke.GTSRB:
            continue
        spec = _spec(name, batch)
        _, dlevels, _, _ = _family(spec)
        assert sp.dgrad_tiled_levels(spec) == []
        for g in dlevels:
            assert sp.dgrad_tile_plan(g.B, g.Cin, g.W, g.M, g.F).tiled == 0


@pytest.mark.parametrize("name,steps", [(chip_smoke.GTSRB, 7),
                                        ("galaxy_rbf", 5)])
def test_tiled_launch_counter_follows_the_mirror(monkeypatch, name, steps):
    """deep_epoch.dgrad_tiled_launches adds what the C loop counted over a
    call: with the C call and its counter stood in for by the mirror (a
    tiled launch each dgrad_tiled_levels level a step), steps x 2 at the
    column and 0 at galaxy_rbf, over two calls."""
    import types

    from theanet_tpu_torch.ops import _build

    spec = _spec(name, None)
    issued = [0]

    def fake_launch(_name, kparams, kmoms, x_steps, *_args):
        issued[0] += x_steps.shape[0] * len(sp.dgrad_tiled_levels(_args[-2]))
        return kparams, kmoms, None

    monkeypatch.setattr(td, "launch_deep", fake_launch)
    monkeypatch.setattr(_build, "dgrad_tiled_launched", lambda: issued[0])
    monkeypatch.setattr(_build, "wgrad_tiled_launched", lambda: 0)
    monkeypatch.setattr(td.deep_epoch, "launches", 0)
    monkeypatch.setattr(td.deep_epoch, "dgrad_tiled_launches", 0)
    x = types.SimpleNamespace(device=torch.device("cuda"), shape=(steps,))
    for _ in range(2):
        td.deep_epoch([], [], x, None, None, 0.1, spec, None)
    want = 2 * steps * (2 if name == chip_smoke.GTSRB else 0)
    assert td.deep_epoch.dgrad_tiled_launches == want
    assert td.deep_epoch.launches == 2


WGRAD_GRID = [(B, M, cin, F, e, cs)
              for B in (1, 5, 20, 3000) for M in (1, 4, 20, 64)
              for cin in (1, 3, 20, 64) for F in (2, 3, 5)
              for e in list(range(1, 700, 11)) + [256, 300] for cs in (1, 2)]


def _parent_admits(M, cin, F, e, cs):
    """Whether the weight-gradient plan before this one (a block a tap
    group, map and slice, with a table of 4 ints a staged row) fit a block
    at some band: at one output row its table, one dz row and the cin x F
    input rows under it."""
    sp_w = (e - 1) * cs + F
    return 4 * (4 * (1 + cin * F) + e + cin * F * sp_w) <= sp.SMEM_OPT_IN


def test_wgrad_plans_over_a_grid():
    """Over a grid of levels the weight gradient's plan covers the batch
    with its units and slices, the maps with its groups and each group's
    outputs with its thread tiles (_wgrad_plan_sound); it admits every
    level the plan before it admitted, and a level it does not admit needs
    more than a block's shared memory even at one output row of one map a
    block. The staging walk of a level wider than the block (sp above the
    block's threads) copies each element once, and sums each position
    once."""
    n_ok = n_past = 0
    for B, M, cin, F, e, cs in WGRAD_GRID:
        p = sp.wgrad_plan(B, M, cin, F, e, cs)
        g = sp.ConvGeom(B, M, cin, F, e, e, cs, 0, (e - 1) * cs + F)
        if 4 * p.smem_floats > sp.SMEM_OPT_IN:
            assert p.ny == 1 and p.mg == 1
            assert 4 * sp.wgrad_unit_floats(1, 1, e, cin, F, cs) > (
                sp.SMEM_OPT_IN)
            assert not _parent_admits(M, cin, F, e, cs)
            n_past += 1
            continue
        n_ok += 1
        _wgrad_plan_sound(g, p)
    assert n_ok > 10000 and n_past > 0   # the grid reaches past the limit
    g = sp.ConvGeom(3, 2, 2, 3, 600, 600, 1, 0, 602)
    p = sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
    assert p.sp > p.threads
    _wgrad_walks_once(g, p)


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
    (64, 4, 5, 176, None), (64, 4, 5, 182, "weight-gradient"),
    (1, 64, 5, 172, None), (1, 64, 5, 173, "input-gradient"),
    (64, 4, 5, 181, None),
], ids=["wgrad-fits", "wgrad-past", "dgrad-fits", "dgrad-past",
        "wgrad-fits-in-map-groups"])
def test_stage_smem_limit_declines_by_name(cin, maps, filt, side, kind):
    """A net whose level 1 stages just inside a block's shared memory at
    one row a band fuses in the deep family; one just past it declines,
    naming the stage, instead of raising at its first epoch. The weight
    gradient's level of side 181 fits only at one map a block, four map
    groups (the plan before this one, with its row table, declined from
    side 178 up)."""
    net = _wide_net(cin, maps, filt, side)
    got = megastep.fused_decline_reason(net)
    plan = megastep.fused_plan(net)
    if kind is None:
        assert got is None and plan.epoch_fn is td.deep_epoch, got
        g = sp.deep_levels(plan.spec)[1]
        p = sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
        assert p.ngr == (4 if side == 181 else 1)
        return
    assert plan is None
    assert f"{kind} stage" in got and "opt in to" in got, got


def test_wide_input_maps_fuse_through_the_tiled_path():
    """A level of 64 input maps whose band path would stage more than a
    block can opt in to (dgrad-past's 173 px input and 64 maps of filter
    5) takes the tiled path, which always fits: the net fuses in the deep
    family, and stage_limit_reason judges the level by its tiled plan."""
    net = _wide_net(64, 64, 5, 173)
    plan = megastep.fused_plan(net)
    assert megastep.fused_decline_reason(net) is None
    assert plan.epoch_fn is td.deep_epoch
    g = sp.deep_levels(plan.spec)[1]
    band = sp.dgrad_plan(g.B, g.Cin, g.W, g.M, g.F)
    tile = sp.dgrad_tile_plan(g.B, g.Cin, g.W, g.M, g.F)
    assert 4 * band.smem_floats > sp.SMEM_OPT_IN
    assert tile.tiled and 4 * tile.smem_floats <= sp.SMEM_OPT_IN
    assert sp.stage_limit_reason(plan.spec) is None
    assert sp.dgrad_tiled_levels(plan.spec) == [g]


# (B, M, Cin, F, e, cs) of the tiled weight gradient's walk: batches 1 to
# 3000, maps and input maps 1 to 256, output sides 1 to 1100, filters 2 to
# 7, strides 1 and 2
WGRAD_TILE_GRID = [(B, M, cin, F, e, cs)
                   for B in (1, 20, 3000) for M in (1, 7, 150, 256)
                   for cin in (1, 3, 100, 256) for e in (1, 6, 42, 333, 1100)
                   for F in range(2, 8) for cs in (1, 2)]


@functools.lru_cache(maxsize=None)
def _tile_block_sound(p):
    """The block of the tiled plan ``p`` (its tile shape and strides): the
    computing threads' WT_R x WT_R sums cover the tile's bm x bn outputs
    exactly once; in every chunk the staging walk copies every dz element
    (position kk < WT_TK, map < bm) and every column element (kk, tap < bn)
    exactly once, each warp instruction's 32 copies to 32 banks, and every
    shared read of the sums lies among the copied elements."""
    assert p.threads == sp.WT_THREADS and p.tmt * p.tnt <= p.threads
    assert p.bmp % 8 == 4 and p.bnp % 8 == 4
    own = np.zeros((p.bm, p.bn), dtype=np.int64)
    reads_m, reads_n = set(), set()
    for maps, taps in sp.wgrad_tile_positions(p).values():
        own[np.ix_(maps, taps)] += 1
        reads_m.update(maps)
        reads_n.update(taps)
    assert (own == 1).all()
    ds, cs_ = sp.wgrad_tile_staging(p)
    for got, width, stride in ((ds, p.bm, p.bmp), (cs_, p.bn, p.bnp)):
        n = sp.WT_TK * stride
        count = np.bincount(got[:, 1], minlength=n)
        staged = (np.arange(n) % stride) < width
        assert (count[staged] == 1).all() and (count[~staged] == 0).all()
        # a warp instruction: lanes of warp w at their j-th copy
        lane_j = np.zeros(p.threads, dtype=np.int64)
        banks = {}
        for t, off in got:
            banks.setdefault((t // 32, lane_j[t]), []).append(off % 32)
            lane_j[t] += 1
        assert all(len(set(b)) == len(b) for b in banks.values())
    # the reads: position k of a chunk at k * stride + a map (tap) < width
    assert max(reads_m) < p.bm and max(reads_n) < p.bn
    return True


def _wgrad_tile_sound(g, p):
    """The tiled plan ``p`` at level ``g``: the tiles cover the level's M x
    nout outputs exactly once (each tile's block its bm x bn once,
    _tile_block_sound); the splits cover the chunks once in order, each at
    least WT_MIN_CH chunks, and the chunks every position of K once (the
    last chunk's positions past K zero-filled); whole clusters of at most
    WG_CLUSTER; the grid CUDA's; the tap table, both buffers and the
    split's sums' tile within a block's shared memory."""
    nout = g.F * g.F * g.Cin + 1
    assert p.tiled == 1
    assert 1 <= p.tmt <= sp.WT_MAX_T and 1 <= p.tnt <= sp.WT_MAX_T
    assert (p.bm, p.bn) == (sp.WT_R * p.tmt, sp.WT_R * p.tnt)
    assert (p.ntm - 1) * p.bm < g.M <= p.ntm * p.bm
    assert (p.ntn - 1) * p.bn < nout <= p.ntn * p.bn
    assert p.tiles == p.ntm * p.ntn
    assert sorted(p.origin(t) for t in range(p.tiles)) == [
        (i * p.bm, j * p.bn) for i in range(p.ntm) for j in range(p.ntn)]
    K = g.B * g.e * g.e
    assert (p.nch - 1) * sp.WT_TK < K <= p.nch * sp.WT_TK
    _covers(p.splits(), p.nch)
    assert min(c1 - c0 for c0, c1 in p.splits()) >= min(p.nch, sp.WT_MIN_CH)
    assert 1 <= p.cl <= sp.WG_CLUSTER and p.ns == p.cl * p.ncl
    assert p.ns <= max(1, p.nch // sp.WT_MIN_CH)
    assert p.smem_floats == 2 * p.bn + max(
        2 * sp.WT_TK * (p.bmp + p.bnp), p.bm * p.bn)
    assert 4 * p.smem_floats <= sp.SMEM_OPT_IN
    gx, gy = p.grid()
    assert gx <= GRID_X and gy <= GRID_YZ
    assert _tile_block_sound(p)


def test_wgrad_tile_walks_over_a_grid():
    """Over a grid of levels (batches 1 to 3000, 1 to 256 maps and input
    maps, output sides 1 to 1100, filters 2 to 7, strides 1 and 2) the
    tiled weight gradient's plan, whichever path the level takes, owns
    every output by one tile and one thread, sums every position of K once
    for it, reads only what its staging wrote (no bank conflict on the
    writes), inside a block's shared memory (_wgrad_tile_sound); it fills
    the card where tiles and chunks allow; the plan takes the tiled path
    exactly where wgrad_plan needs more than one pass of thread tiles."""
    n_tiled = 0
    for B, M, cin, F, e, cs in WGRAD_TILE_GRID:
        g = sp.ConvGeom(B, M, cin, F, e, e, cs, 0, (e - 1) * cs + F)
        p = sp.wgrad_tile_shape(B, M, cin, F, e, cs)
        _wgrad_tile_sound(g, p)
        if p.tiles * (p.nch // sp.WT_MIN_CH) >= sp.WT_TARGET:
            assert p.tiles * p.ns >= sp.SM_COUNT
        q = sp.wgrad_tile_plan(B, M, cin, F, e, cs)
        wide = sp.wgrad_plan(B, M, cin, F, e, cs).passes > 1
        assert q == (p if wide else sp.WgradTilePlan(*[0] * 16))
        n_tiled += q.tiled
    assert 0 < n_tiled < len(WGRAD_TILE_GRID)


COLUMN_WGRAD = {"level1": (3, 48, 100, 7), "level2": (100, 21, 150, 4),
                "level3": (150, 9, 250, 4)}


def test_wgrad_paths_by_shape():
    """The GTSRB column's three weight-gradient levels take the tiled path,
    filling the card at B 20, and GEOM_SMALL's wgrad-passes-l1 its level 1;
    every level of every other configuration here (mnist_cnn at B 20 and
    256, galaxy_rbf, synth_aux, the geometry, head and per-rank
    configurations) and of the other GEOM_SMALL cases keeps k_wgrad."""
    col = _spec(chip_smoke.GTSRB, None)
    tiled = sp.wgrad_tiled_levels(col)
    assert tiled == sp.deep_levels(col)
    assert [(g.Cin, g.W, g.M, g.F) for g in tiled] == list(
        COLUMN_WGRAD.values())
    for g in tiled:
        p = sp.wgrad_tile_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
        assert g.B == 20 and np.prod(p.grid()) >= sp.SM_COUNT
        assert sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs).passes > 1
    names = {n for n, _ in CONFIGS} - {chip_smoke.GTSRB}
    assert {"mnist_cnn", "galaxy_rbf", "synth_aux", "flat_mlp"} <= names
    assert set(chip_smoke.GEOM_CONFIGS) <= names
    for name, batch in CONFIGS + [("mnist_cnn", 256)]:
        if name == chip_smoke.GTSRB:
            continue
        spec = _spec(name, batch)
        levels, _, _, _ = _family(spec)
        assert sp.wgrad_tiled_levels(spec) == []
        for g in levels:
            assert sp.wgrad_tile_plan(g.B, g.M, g.Cin, g.F, g.e,
                                      g.cs).tiled == 0
    for name in chip_smoke.GEOM_SMALL:
        _, plan, _, _ = chip_smoke.geometry_small(torch, name, "cpu")
        levels = sp.deep_levels(plan.spec)
        want = levels[1:] if name == "wgrad-passes-l1" else []
        assert sp.wgrad_tiled_levels(plan.spec) == want, name


@pytest.mark.parametrize("name,steps", [(chip_smoke.GTSRB, 7),
                                        ("galaxy_rbf", 5)])
def test_wgrad_tiled_launch_counter_follows_the_mirror(monkeypatch, name,
                                                       steps):
    """deep_epoch.wgrad_tiled_launches adds what the C loop counted over a
    call: with the C call and its counter stood in for by the mirror (a
    tiled launch each wgrad_tiled_levels level a step), steps x 3 at the
    column and 0 at galaxy_rbf, over two calls; the mnist_cnn
    configurations run the flagship, whose levels the mirror keeps on
    k_wgrad."""
    import types

    from theanet_tpu_torch.ops import _build

    spec = _spec(name, None)
    issued = [0]

    def fake_launch(_name, kparams, kmoms, x_steps, *_args):
        issued[0] += x_steps.shape[0] * len(sp.wgrad_tiled_levels(_args[-2]))
        return kparams, kmoms, None

    monkeypatch.setattr(td, "launch_deep", fake_launch)
    monkeypatch.setattr(_build, "dgrad_tiled_launched", lambda: 0)
    monkeypatch.setattr(_build, "wgrad_tiled_launched", lambda: issued[0])
    monkeypatch.setattr(td.deep_epoch, "launches", 0)
    monkeypatch.setattr(td.deep_epoch, "wgrad_tiled_launches", 0)
    x = types.SimpleNamespace(device=torch.device("cuda"), shape=(steps,))
    for _ in range(2):
        td.deep_epoch([], [], x, None, None, 0.1, spec, None)
    want = 2 * steps * (3 if name == chip_smoke.GTSRB else 0)
    assert td.deep_epoch.wgrad_tiled_launches == want
    assert td.deep_epoch.launches == 2
    for batch in (None, 256):
        assert sp.wgrad_tiled_levels(_spec("mnist_cnn", batch)) == []


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
    "b305-ragged-slices": (305, 3, 12, 8, 3, 1, "valid", 0),
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


def wgrad_clustered(dz, x, g, plan=None):
    """A conv level's weight and bias gradients (kernel layout (M, F*F*Cin)
    and (M,)) as k_wgrad computes them: for each slice of ``plan`` and map
    group, each staging round's units copied to the kernel's shared-memory
    offsets (the group's dz rows, the zero-padded input rows under them),
    every output's taps read at the kernel's offsets from each position's
    (the bias a tap of input 1); then the slices' sums added in slice
    order within each cluster of cl slices and the clusters' in cluster
    order. ``dz`` (B, M, c, c), ``x`` (B, Cin, W, W), ``g`` the level's
    ConvGeom."""
    p = plan or sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
    e, cs, F, spw, W = g.e, g.cs, g.F, p.sp, g.W
    t = torch.arange(p.nout - 1)
    ci, uv = t % g.Cin, t // g.Cin
    ooff = ci * p.hb * spw + (F - 1 - uv // F) * spw + (F - 1 - uv % F)
    dzu, inu = p.mg * p.ny * e, g.Cin * p.hb * spw
    part = torch.zeros((p.nsl, g.M, p.nout), dtype=dz.dtype)
    grid = lambda *n: [a.reshape(-1) for a in torch.meshgrid(
        *[torch.arange(k) for k in n], indexing="ij")]
    for m0 in range(0, g.M, p.mg):
        mgc = min(p.mg, g.M - m0)
        moff = torch.arange(mgc) * p.ny * e
        for s in range(p.nsl):
            for b, y0, ny, nbt in p.rounds(g.B, s, e):
                hb = (ny - 1) * cs + F
                sdz = torch.zeros(p.nbs * dzu, dtype=dz.dtype)
                sin = torch.zeros(p.nbs * inu, dtype=x.dtype)
                u, m, y, xx = grid(nbt, mgc, ny, e)
                sdz[((u * p.mg + m) * p.ny + y) * e + xx] = dz[
                    b + u, m0 + m, y0 + y, xx]
                u, c, h, col = grid(nbt, g.Cin, hb, spw)
                iy, ix = y0 * cs + h - g.pad, col - g.pad
                inside = (iy >= 0) & (iy < W) & (ix >= 0) & (ix < W)
                vals = x[b + u, c, iy.clamp(0, W - 1), ix.clamp(0, W - 1)]
                sin[((u * g.Cin + c) * p.hb + h) * spw + col] = torch.where(
                    inside, vals, torch.zeros_like(vals))
                u, y, xx = grid(nbt, ny, e)
                pd = u * dzu + y * e + xx
                pi = u * inu + y * cs * spw + xx * cs
                dzv = sdz[pd[:, None] + moff[None, :]]          # (P, mgc)
                xv = sin[pi[:, None] + ooff[None, :]]           # (P, taps)
                part[s, m0:m0 + mgc, :-1] += dzv.T @ xv
                part[s, m0:m0 + mgc, -1] += dzv.sum(0)
    total = None
    for c0 in range(0, p.nsl, p.cl):
        csum = torch.zeros_like(part[0])
        for k in range(c0, min(p.nsl, c0 + p.cl)):
            csum = csum + part[k]
        total = csum if total is None else total + csum
    return total[:, :-1], total[:, -1]


def _wgrad_plan_at(g, ny):
    """wgrad_plan at level ``g`` with bands of ``ny`` output rows forced,
    a slice a band (the form a level too wide for 48 KB takes)."""
    p = sp.wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
    nbn = -(-g.e // ny)
    nsl = g.B * nbn
    cl = min(sp.WG_CLUSTER, nsl)
    return p._replace(ny=ny, nbn=nbn, nu=1, nbs=1, nsl=nsl, cl=cl,
                      nslp=-(-nsl // cl) * cl, hb=(ny - 1) * g.cs + g.F)


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
    if name == "b302-ragged-slices":   # a padding slice ends the grid
        assert p.nu > 1 and p.nbs > 1 and p.nslp > p.nsl
    if name == "b305-ragged-slices":   # the last slice is short
        assert p.nu > 1 and g.B % p.nu != 0 and p.nbs > 1
    got_w, got_b = wgrad_clustered(torch.from_numpy(dz), torch.from_numpy(x),
                                   g, p)
    # kernel layout: dw_k[m, (u*F+v)*Cin + c] = dw[m, c, u, v]
    _close(got_w, dw.transpose(0, 2, 3, 1).reshape(g.M, -1))
    _close(got_b, db)


@pytest.mark.parametrize("ny", [1, 2, 3])
def test_wgrad_bands_match_jax(ny):
    """A plan with fewer staged rows than the level has (the form a wide
    level takes to fit 48 KB), and one with map groups of one map (a level
    too wide for all its maps), give the same sums."""
    g, x, w, b, dz = _conv_case("stride2")
    dw, db, _ = _jax_conv_grads(x, w, b, dz, g.cs, "valid")
    want_w, want_b = dw.transpose(0, 2, 3, 1).reshape(g.M, -1), db
    p = _wgrad_plan_at(g, ny)
    for plan in (p, p._replace(mg=1, ngr=g.M)):
        got_w, got_b = wgrad_clustered(torch.from_numpy(dz),
                                       torch.from_numpy(x), g, plan)
        _close(got_w, want_w)
        _close(got_b, want_b)


@functools.lru_cache(maxsize=None)
def _level_case(g):
    """Seeded inputs at a configuration's conv level ``g`` and jax.grad's
    (dw in kernel layout, db) of the JAX ConvLayer there."""
    mode = {0: "valid", g.F // 2: "same", g.F - 1: "full"}[g.pad]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((g.B, g.Cin, g.W, g.W)).astype(np.float32)
    w = (rng.standard_normal((g.M, g.Cin, g.F, g.F)) / g.F).astype(
        np.float32)
    b = rng.standard_normal(g.M).astype(np.float32)
    dz = rng.standard_normal((g.B, g.M, g.c, g.c)).astype(np.float32)
    dz[:, :, g.e:] = 0.0   # outside the pools' windows: no gradient
    dz[:, :, :, g.e:] = 0.0
    dw, db, _ = _jax_conv_grads(x, w, b, dz, g.cs, mode)
    return x, dz, dw.transpose(0, 2, 3, 1).reshape(g.M, -1), db


@pytest.mark.parametrize("name,batch", CONFIGS)
def test_wgrad_order_matches_jax_at_configs(name, batch):
    """At every conv level of every configuration here (the plans the
    kernels run), the weight gradient's order model against jax.grad."""
    levels, _, _, _ = _family(_spec(name, batch))
    for g in levels:
        x, dz, want_w, want_b = _level_case(g)
        got_w, got_b = wgrad_clustered(torch.from_numpy(dz),
                                       torch.from_numpy(x), g)
        _close(got_w, want_w)
        _close(got_b, want_b)


@pytest.mark.parametrize("name", CONV_CASES)
def test_dgrad_canvas_matches_jax(name):
    g, x, w, b, dz = _conv_case(name, seed=1)
    _, _, dx = _jax_conv_grads(x, w, b, dz, g.cs, CONV_CASES[name][6])
    w_k = torch.from_numpy(w.transpose(0, 2, 3, 1).reshape(g.M, -1).copy())
    p = sp.dgrad_plan(g.B, g.Cin, g.W, g.M, g.F)
    _close(dgrad_canvas(torch.from_numpy(dz), w_k, g, p), dx)
    one_band = p._replace(rows=g.W, nbands=1)
    _close(dgrad_canvas(torch.from_numpy(dz), w_k, g, one_band), dx)


def dgrad_tiled(dz, w_k, g, plan):
    """A conv level's input gradient (B, Cin, W, W) as k_conv_dgrad_tiled
    computes it: for every block (band, tile of cit input maps, sample)
    and every chunk of km maps, the chunk's weights (a row of cit a (map,
    tap), zero past Cin) and canvas rows (rows + F - 1 of the band, dpp
    wide: dz dilated by the stride at F-1-pad, zero elsewhere) copied to
    the kernel's shared-memory offsets; each thread's DT_TCI x DT_TJ sums
    (dgrad_tile_positions) read there, map by map in chunk order, tap by
    tap (u, v); the outputs inside the level stored."""
    p, F, B = plan, g.F, g.B
    FF, hb, cit, tci, tj = g.F * g.F, p.rows + F - 1, p.cit, sp.DT_TCI, \
        sp.DT_TJ
    off = F - 1 - g.pad
    canvas = torch.zeros((B, g.M, p.nbands * p.rows + F - 1, p.dpp),
                         dtype=dz.dtype)
    ys = torch.arange(g.e) * g.cs + off
    canvas[:, :, ys[:, None], ys[None, :]] = dz[:, :, :g.e, :g.e]
    wpad = torch.zeros((g.M * FF, p.nct * cit), dtype=w_k.dtype)
    wpad[:, :g.Cin] = w_k.reshape(g.M * FF, g.Cin)
    grp, row, til = (torch.tensor(v) for v in zip(
        *sp.dgrad_tile_positions(g, p).values()))
    c, q = torch.arange(tci), torch.arange(tj)
    acc = torch.zeros((B, p.nbands, p.nct, len(grp), tci, tj),
                      dtype=dz.dtype)
    for ch in range(p.nch):
        m0 = ch * p.km
        kmc = min(p.km, g.M - m0)
        # every block's staged buffers: (tiles, kmc*FF*cit) and (B, bands,
        # kmc*hb*dpp), at the offsets dgrad_tile_staging walks
        ws = wpad[m0 * FF:(m0 + kmc) * FF].reshape(kmc * FF, p.nct, cit)
        ws = ws.permute(1, 0, 2).reshape(p.nct, -1)
        cv = torch.stack([canvas[:, m0:m0 + kmc, b0 * p.rows:
                                 b0 * p.rows + hb].reshape(B, -1)
                          for b0 in range(p.nbands)], 1)
        for mk in range(kmc):
            for u in range(F):
                for v in range(F):
                    wi = (mk * FF * cit + (u * F + v) * cit
                          + grp[:, None] * tci + c[None, :])
                    ci = ((mk * hb + row[:, None] + u) * p.dpp
                          + til[:, None] * tj + q[None, :] + v)
                    acc = acc + (ws[:, wi][None, None, :, :, :, None]
                                 * cv[:, :, ci][:, :, None, :, None, :])
    # (B, band, tile, thread, c, q) -> din[b, ci, i, j]
    full = torch.zeros((B, p.nct * cit, p.nbands * p.rows, p.nj * tj),
                       dtype=dz.dtype)
    for k in range(len(grp)):
        for b0 in range(p.nbands):
            i = b0 * p.rows + int(row[k])
            cis = (torch.arange(p.nct)[:, None] * cit + int(grp[k]) * tci
                   + c[None, :]).reshape(-1)
            js = int(til[k]) * tj + q
            full[:, cis[:, None], i, js[None, :]] = acc[:, b0, :, k].reshape(
                B, -1, tj)
    return full[:, :g.Cin, :g.W, :g.W]


@pytest.mark.parametrize("name", CONV_CASES)
def test_dgrad_tiled_matches_jax(name):
    """The tiled path's order model against jax.grad at every conv case
    (their few input maps take the band path; the tile shape is held here
    all the same: input maps past Cin, rows past the last band and columns
    past the last tile are zeros that no output keeps)."""
    g, x, w, b, dz = _conv_case(name, seed=1)
    _, _, dx = _jax_conv_grads(x, w, b, dz, g.cs, CONV_CASES[name][6])
    w_k = torch.from_numpy(w.transpose(0, 2, 3, 1).reshape(g.M, -1).copy())
    p = sp.dgrad_tile_shape(g.B, g.Cin, g.W, g.M, g.F)
    _close(dgrad_tiled(torch.from_numpy(dz), w_k, g, p), dx)
    # a chunk of one map and a band of one row
    one = p._replace(km=1, nch=g.M, rows=1, nbands=g.W,
                     threads=-(-p.g * p.nj // 32) * 32)
    _close(dgrad_tiled(torch.from_numpy(dz), w_k, g, one), dx)


@pytest.mark.parametrize("level", COLUMN_LEVELS)
def test_dgrad_tiled_matches_jax_at_the_column(level):
    """The tiled path at the GTSRB column's two input-gradient levels at B
    2 (the plan there: several bands and tiles, chunks of 16 maps, the
    last short at level 2) against jax.grad of the JAX ConvLayer."""
    cin, W, M, F = COLUMN_LEVELS[level]
    g = _geom(2, cin, W, M, F, 1, "valid", 0)
    p = sp.dgrad_tile_plan(g.B, g.Cin, g.W, g.M, g.F)
    assert p.tiled and p.nch > 1 and p.nbands > 1 and p.nct > 1
    rng = np.random.default_rng(4)
    x = rng.standard_normal((g.B, cin, W, W)).astype(np.float32)
    w = (rng.standard_normal((M, cin, F, F)) / (F * np.sqrt(M))).astype(
        np.float32)
    b = rng.standard_normal(M).astype(np.float32)
    dz = rng.standard_normal((g.B, M, g.c, g.c)).astype(np.float32)
    _, _, dx = _jax_conv_grads(x, w, b, dz, 1, "valid")
    w_k = torch.from_numpy(w.transpose(0, 2, 3, 1).reshape(M, -1).copy())
    _close(dgrad_tiled(torch.from_numpy(dz), w_k, g, p), dx)


def wgrad_tiled(dz, x, g, plan):
    """A conv level's weight and bias gradients (kernel layout (M, F*F*Cin)
    and (M,)) in k_wgrad_tiled's order: every position k of the plan's
    chunks staged as its dz row of the maps and its im2col'd column of the
    taps at the tap table's (du, dv) (zero off the input and past K, the
    bias tap 1); each split's sum of an output carried position by
    position through its chunks in order, a product added as fmaf adds it
    (exact in float64, one rounding to float32; the double rounding
    differs from fmaf's once in billions); a tile's splits added in split
    order from 0 within each cluster of cl, the clusters' sums in cluster
    order from 0. A position's sums do not depend on the tile that holds
    the output, so every tile's are carried at once. ``dz`` (B, M, c, c),
    ``x`` (B, Cin, W, W), ``g`` the level's ConvGeom."""
    p, F, e, W = plan, g.F, g.e, g.W
    nout = F * F * g.Cin + 1
    k = torch.arange(p.nch * sp.WT_TK)
    kv = k < g.B * e * e
    kc = torch.where(kv, k, torch.zeros_like(k))
    b, y, xx = kc // (e * e), kc % (e * e) // e, kc % e
    D = torch.zeros((len(k), p.ntm * p.bm), dtype=dz.dtype)
    D[:, :g.M] = dz[b, :, y, xx] * kv[:, None]
    t = torch.arange(nout - 1)
    ci, uv = t % g.Cin, t // g.Cin
    du, dv = F - 1 - uv // F - g.pad, F - 1 - uv % F - g.pad
    iy, ix = y[:, None] * g.cs + du[None, :], xx[:, None] * g.cs + dv[None, :]
    inside = (iy >= 0) & (iy < W) & (ix >= 0) & (ix < W) & kv[:, None]
    vals = x[b[:, None], ci[None, :], iy.clamp(0, W - 1), ix.clamp(0, W - 1)]
    C = torch.zeros((len(k), p.ntn * p.bn), dtype=x.dtype)
    C[:, :nout - 1] = torch.where(inside, vals, torch.zeros_like(vals))
    C[:, nout - 1] = 1.0
    # chunk p.nch: a zero chunk, the steps past a shorter split's end
    Dc = torch.cat([D.double(), torch.zeros_like(D[:sp.WT_TK]).double()])
    Cc = torch.cat([C.double(), torch.zeros_like(C[:sp.WT_TK]).double()])
    Dc = Dc.reshape(p.nch + 1, sp.WT_TK, -1)
    Cc = Cc.reshape(p.nch + 1, sp.WT_TK, -1)
    spl = p.splits()
    longest = max(c1 - c0 for c0, c1 in spl)
    acc = torch.zeros((p.ns, Dc.shape[2], Cc.shape[2]), dtype=torch.float32)
    for j in range(longest):
        ch = torch.tensor([c0 + j if c0 + j < c1 else p.nch
                           for c0, c1 in spl])
        for kk in range(sp.WT_TK):
            a, bb = Dc[ch, kk], Cc[ch, kk]
            acc = (acc.double() + a[:, :, None] * bb[:, None, :]).float()
    total = torch.zeros(acc.shape[1:], dtype=torch.float32)
    for c in range(p.ncl):
        csum = torch.zeros_like(total)
        for r in range(p.cl):
            csum = csum + acc[c * p.cl + r]
        total = total + csum
    return total[:g.M, :nout - 1], total[:g.M, nout - 1]


@pytest.mark.parametrize("name", CONV_CASES)
def test_wgrad_tiled_matches_jax(name):
    """The tiled weight gradient's order model against jax.grad at every
    conv case (their narrow levels keep k_wgrad; the tiled shape is held
    here all the same: 'same' and 'full' taps off the input, strides,
    positions past the pools' windows, splits in clusters at B 302 and
    305), and with its splits forced to one and to a cluster of two."""
    g, x, w, b, dz = _conv_case(name, seed=2)
    dw, db, _ = _jax_conv_grads(x, w, b, dz, g.cs, CONV_CASES[name][6])
    want_w = dw.transpose(0, 2, 3, 1).reshape(g.M, -1)
    p = sp.wgrad_tile_shape(g.B, g.M, g.Cin, g.F, g.e, g.cs)
    if name.startswith("b30"):
        assert p.ncl > 1
    plans = [p, p._replace(ns=1, cl=1, ncl=1)]
    if p.nch >= 2:
        plans.append(p._replace(ns=2, cl=2, ncl=1))
    for plan in plans:
        got_w, got_b = wgrad_tiled(torch.from_numpy(dz), torch.from_numpy(x),
                                   g, plan)
        _close(got_w, want_w)
        _close(got_b, db)


@pytest.mark.parametrize("level", COLUMN_WGRAD)
def test_wgrad_tiled_matches_jax_at_the_column(level):
    """The tiled weight gradient at the GTSRB column's three levels at B 2
    (the plans there: level 1 one tile and six clusters of 8 splits, level
    2 17 tiles in one cluster of 8, level 3 38 tiles and K whole) against
    jax.grad of the JAX ConvLayer."""
    cin, W, M, F = COLUMN_WGRAD[level]
    g = _geom(2, cin, W, M, F, 1, "valid", 0)
    g = g._replace(e=g.c // 2 * 2)   # the pools' windows (pool 2)
    p = sp.wgrad_tile_shape(g.B, g.M, g.Cin, g.F, g.e, g.cs)
    assert p == sp.wgrad_tile_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
    assert {"level1": p.ncl > 1, "level2": p.tiles > 1 and p.ns > 1,
            "level3": p.ns == 1 and p.ntm > 1}[level], p
    rng = np.random.default_rng(5)
    x = rng.standard_normal((g.B, cin, W, W)).astype(np.float32)
    w = (rng.standard_normal((M, cin, F, F)) / F).astype(np.float32)
    b = rng.standard_normal(M).astype(np.float32)
    dz = rng.standard_normal((g.B, M, g.c, g.c)).astype(np.float32)
    dz[:, :, g.e:] = 0.0
    dz[:, :, :, g.e:] = 0.0
    dw, db, _ = _jax_conv_grads(x, w, b, dz, 1, "valid")
    got_w, got_b = wgrad_tiled(torch.from_numpy(dz), torch.from_numpy(x), g,
                               p)
    _close(got_w, dw.transpose(0, 2, 3, 1).reshape(M, -1))
    _close(got_b, db)


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

"""The tiling plan of the port's tensor-core 3x3 conv (``conv3x3_plan`` in
``ops/conv3x3.py``, passed to ``csrc/conv3x3.cu``) and the numeric claim
its f32 form rests on, on the CPU.

The kernel cannot run here, so these pin what it is handed: for every
shape of chip_smoke.py's phase 13 and a grid of eligible shapes, each
launch's shared bytes fit the 227 KB opt-in, its grid fits CUDA's limits,
the conv strips cover every output pixel exactly once and the dw slices
cover the batch in order, each at most DW_DEPTH terms deep. Then a torch
emulation of the f32 form (3xTF32: operands split into TF32 hi and lo
parts rounded on the bits as cvt.rna.tf32.f32 rounds, lo*hi + hi*lo +
hi*hi into a fresh partial over two MMA steps of the conv body or one of
dw, the partials summed in f32 in the kernel's depth order, dw in the
plan's slices) comes within the f32 bound
of chip_smoke.py's phase 13, 2^-18 of the plain f32 version's largest
value, where one TF32 pass does not.
"""

import math

import numpy as np
import pytest
import torch

from theanet_tpu_torch.ops import conv3x3 as cv

import chip_smoke

RAGGED = [(1, 16, 3, 8), (5, 40, 30, 24), (2, 136, 9, 200)]
CASES = chip_smoke.CONV_CASES
DTYPES = (torch.float32, torch.bfloat16)
GRID_MAX = 2 ** 31 - 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_phase13_holds_the_ragged_cases():
    assert all(c in CASES for c in RAGGED)


def _check_pass(p, B, K, N, esize):
    """A conv pass: fits shared memory and the grid; its strips cover
    each output pixel of an image once (every image: the grid's z is B);
    its padding is whole MMA steps and whole tiles."""
    assert p.smem <= cv.SMEM_OPT_IN
    gx, gy, gz = p.grid(B)
    assert 1 <= gx <= GRID_MAX and 1 <= gy <= cv.GRID_YZ and gz == B
    assert gz <= cv.GRID_YZ
    assert p.kp >= K and (p.kp * esize) % cv.KSPAN == 0
    assert p.np >= N and p.np % p.bn == 0 and p.bn in (32, 64, 128)
    _check_strips(p.strips, 256 if p.bn == 64 else 128)


def _check_strips(st, pixels):
    """Tiles of at most ``pixels`` that cover the map once."""
    assert st.rows * st.cols <= pixels and st.rows >= 1 and st.cols >= 1
    hits = np.zeros((st.out, st.out), np.int64)
    for oy0, ox0, rows, cols in st.tiles():
        assert rows >= 1 and cols >= 1
        hits[oy0:oy0 + rows, ox0:ox0 + cols] += 1
    assert (hits == 1).all()


def _check_plan(B, C, H, M, dtype):
    plan = cv.conv3x3_plan(B, C, H, M, dtype)
    esize = 2 if dtype == torch.bfloat16 else 4
    assert plan.esize == esize
    _check_pass(plan.fwd, B, C, M, esize)
    _check_pass(plan.dgrad, B, M, C, esize)
    assert (plan.fwd.side, plan.fwd.strips.out) == (H, H - 2)
    assert (plan.dgrad.side, plan.dgrad.strips.out) == (H + 2, H)
    _check_strips(plan.dw, cv.BM)
    # dw: the slices cover units 0 .. B * strips - 1 in order, each at
    # most DW_DEPTH terms (output pixels) deep
    assert plan.wg_smem <= cv.SMEM_OPT_IN
    gx, gy, gz = plan.wg_grid()
    assert gx == plan.slices and 1 <= gx <= GRID_MAX
    assert 1 <= gy <= cv.GRID_YZ and 1 <= gz <= cv.GRID_YZ
    depth = np.array([r * c for _, _, r, c in plan.dw.tiles()], np.int64)
    per_unit = np.tile(depth, B)
    prefix = np.concatenate([[0], np.cumsum(per_unit)])
    end = 0
    for first, stop in plan.slice_units():
        assert first == end and stop > first
        assert prefix[stop] - prefix[first] <= cv.DW_DEPTH
        end = stop
    assert end == plan.units == B * plan.dw.strips
    assert prefix[-1] == B * (H - 2) ** 2
    assert plan.cq >= C and plan.cq % cv.WG_C == 0
    assert len(plan.ints()) == 18
    return plan


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", CASES, ids=str)
def test_plan_of_phase13_shapes(shape, dtype):
    plan = _check_plan(*shape, dtype)
    for name, (dims, _) in plan.scratch().items():
        assert all(n >= 1 for n in dims), name


def test_plan_over_eligible_grid():
    """C, M in {8, 16, 24, 64, 136, 256}, H in 3..64, B in {1, 3, 20, 256,
    511}, both dtypes."""
    widths = (8, 16, 24, 64, 136, 256)
    n = 0
    for dtype in DTYPES:
        for B in (1, 3, 20, 256, 511):
            for H in range(3, 65):
                for C in widths:
                    for M in widths:
                        _check_plan(B, C, H, M, dtype)
                        n += 1
    assert n == 2 * 5 * 62 * 36


def test_plan_at_the_wide_shape():
    """bench.py's wide conv2: 5 rows of 25 a strip, all 128 maps a tile;
    dx 9 rows of 27 and 64 channels a tile; two blocks' shared memory an
    SM (bf16), and a few thousand terms a dw slice over one wave of
    blocks."""
    plan = cv.conv3x3_plan(*chip_smoke.CONV_WIDE, torch.bfloat16)
    f, d = plan.fwd, plan.dgrad
    assert (f.strips.rows, f.strips.cols, f.strips.strips, f.bn, f.np) == (
        5, 25, 5, 128, 128)
    assert (d.strips.rows, d.strips.cols, d.strips.strips, d.bn, d.kp) == (
        9, 27, 3, 64, 128)
    for p in (f, d):
        assert 2 * (p.smem + 1024) <= 233472
    assert (plan.dw.rows, plan.dw.cols) == (5, 25)
    per_unit = [r * c for _, _, r, c in plan.dw.tiles()] * plan.B
    depths = [sum(per_unit[a:b]) for a, b in plan.slice_units()]
    assert 1000 <= max(depths) <= cv.DW_DEPTH
    tiles = math.prod(plan.wg_grid()[1:])
    assert plan.slices * tiles <= 2 * cv.SMS


def test_plan_refuses_other_dtypes():
    with pytest.raises(ValueError):
        cv.conv3x3_plan(2, 16, 9, 8, torch.float16)


# ---------------------------------------------------------------- 3xTF32

def tf32(a):
    """f32 -> TF32 as cvt.rna.tf32.f32 rounds: to nearest on the 13
    dropped mantissa bits, ties away from zero, on the bits."""
    bits = a.contiguous().view(torch.int32)
    # sign and magnitude: adding half of the dropped ulp to the bits rounds
    # the magnitude half away from zero
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(a):
    hi = tf32(a)
    return hi, tf32(a - hi)


def three_pass(a, b):
    """One partial: lo*hi + hi*lo + hi*hi, from 0."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def _step_dims(K, esize=4):
    """f32 elements of a staged chunk, of the conv body's partial (two MMA
    steps) and of dw's (one)."""
    return cv.CHUNK // esize, cv.KSPAN // esize, cv.KSTEP // esize


def conv_emulated(inp, wt, passes=3):
    """The conv body in f32: inp (B, K, S, S), wt (N, K, 3, 3) (already
    flipped for dx) -> (B, N, S-2, S-2), depth in the kernel's order
    (chunk, tap, 16 channels a partial), each partial added to the sum in
    f32. ``passes`` 1 is one TF32 pass."""
    B, K, S, _ = inp.shape
    N, O = wt.shape[0], S - 2
    chunk, ks, _ = _step_dims(K)
    acc = torch.zeros(B * O * O, N)
    for c0 in range(0, K, chunk):
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            for k in range(c0, min(K, c0 + chunk), ks):
                a = inp[:, k:k + ks, ky:ky + O, kx:kx + O]
                a = a.permute(0, 2, 3, 1).reshape(-1, a.shape[1])
                b = wt[:, k:k + ks, ky, kx].T
                if passes == 3:
                    acc += three_pass(a, b)
                else:
                    acc += tf32(a) @ tf32(b)
    return acc.reshape(B, O, O, N).permute(0, 3, 1, 2)


def dx_emulated(w, dz):
    """dx: the conv body over dz zero-padded by 2 with the flipped taps,
    weights (C, M)."""
    dzp = torch.nn.functional.pad(dz, (2, 2, 2, 2))
    wt = torch.flip(w, (2, 3)).transpose(0, 1)
    return conv_emulated(dzp, wt)


def dw_emulated(plan, x, dz):
    """dw: each slice sums its units' output pixels 8 a partial (a unit's
    last one padded with zero rows) into its own f32 sum, partial by
    partial; then the slices in order."""
    B, C, H, _ = x.shape
    M, O = dz.shape[1], H - 2
    _, _, ks = _step_dims(C)
    # rows (b, oy, ox) of dz and of the tap-major patches, and a zero row
    cols = torch.stack([x[:, :, ky:ky + O, kx:kx + O]
                        for ky in range(3) for kx in range(3)], 1)
    cols = cols.permute(0, 3, 4, 1, 2).reshape(B * O * O, 9 * C)
    dzr = dz.permute(0, 2, 3, 1).reshape(B * O * O, M)
    cols = torch.cat([cols, torch.zeros(1, 9 * C)])
    dzr = torch.cat([dzr, torch.zeros(1, M)])
    zero = B * O * O
    # each slice's depth as row indices, steps of ks, zero rows to fill
    tiles = list(plan.dw.tiles())
    slices = []
    for first, stop in plan.slice_units():
        rows = []
        for u in range(first, stop):
            b, st = divmod(u, len(tiles))
            oy0, ox0, nr, nc = tiles[st]
            idx = (b * O + np.arange(oy0, oy0 + nr)[:, None]) * O + \
                np.arange(ox0, ox0 + nc)[None, :]
            idx = idx.ravel()
            rows += [idx, np.full(-len(idx) % ks, zero)]
        slices.append(np.concatenate(rows))
    depth = max(len(r) for r in slices)
    index = torch.tensor(np.stack([np.pad(r, (0, depth - len(r)),
                                          constant_values=zero)
                                   for r in slices]))
    acc = torch.zeros(len(slices), M, 9 * C)
    for k in range(0, depth, ks):
        step = index[:, k:k + ks]
        acc += three_pass(dzr[step].transpose(1, 2), cols[step])
    total = torch.zeros(M, 9 * C)
    for s in range(len(slices)):
        total += acc[s]
    return total.reshape(M, 9, C).permute(0, 2, 1).reshape(M, C, 3, 3)


def _inputs(shape, seed=0):
    """phase 13's scales (chip_smoke.conv_inputs), drawn with numpy."""
    B, C, H, M = shape
    O = H - 2
    rng = np.random.RandomState(seed)
    x = rng.rand(B, C, H, H).astype(np.float32)
    w = (rng.randn(M, C, 3, 3) * (0.5 / math.sqrt(9 * C))).astype(np.float32)
    dz = (rng.randn(B, M, O, O) / math.sqrt(B * O * O)).astype(np.float32)
    return torch.tensor(x), torch.tensor(w), torch.tensor(dz)


def test_tf32_rounds_as_the_card():
    one = 1.0 + 2.0 ** -10
    v = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23,
                      -(1.0 + 2.0 ** -11), one, 3.0 * 2.0 ** -11])
    got = tf32(v)
    assert got.tolist() == [one, 1.0, -one, one, 3.0 * 2.0 ** -11]
    # hi keeps 11 significant bits, hi + lo 22
    a = torch.tensor([math.pi])
    hi, lo = split(a)
    assert abs(float(hi - a)) > 2.0 ** -12
    assert abs(float(hi + lo - a)) <= 2.0 ** -21 * math.pi


@pytest.mark.parametrize("shape", CASES, ids=str)
def test_three_tf32_passes_hold_the_f32_bound(shape):
    """z and dx on the first 8 images (each of their outputs sums 9C or 9M
    terms whatever the batch); dw over the whole batch in the plan's
    slices."""
    x, w, dz = _inputs(shape)
    plan = cv.conv3x3_plan(*shape, torch.float32)
    rel = chip_smoke.CONV_REL["float32"]
    ref = cv.conv3x3_forward_reference(x[:8], w)
    rdx = cv.conv3x3_backward_reference(x[:8], w, dz[:8])[0]
    rdw = cv.conv3x3_backward_reference(x, w, dz)[1]
    for what, got, r in (("z", conv_emulated(x[:8], w), ref),
                         ("dx", dx_emulated(w, dz[:8]), rdx),
                         ("dw", dw_emulated(plan, x, dz), rdw)):
        err = float((got - r).abs().max())
        lim = rel * float(r.abs().max())
        assert err <= lim, (shape, what, err, lim)


def test_one_tf32_pass_misses_the_f32_bound():
    """Why the f32 form takes three passes: one misses by over 10x at the
    wide shape's forward."""
    x, w, _ = _inputs(chip_smoke.CONV_WIDE)
    x = x[:8]
    ref = cv.conv3x3_forward_reference(x, w)
    err = float((conv_emulated(x, w, passes=1) - ref).abs().max())
    lim = chip_smoke.CONV_REL["float32"] * float(ref.abs().max())
    assert err > 10 * lim, (err, lim)

"""Launch plans of the fused families' gradient and product stages.

``csrc/stages.cuh`` runs three stage kinds of every fused step on plans
that depend on the shapes alone, so that every sum across blocks runs in
one order on every run and every rank. This module mirrors them line for
line (``chip_smoke.py`` holds each mirror to the C's ``stage_*_plan`` and
``*_workspace_floats`` on the card; tests/test_torch_stage_plan.py pins
them on the CPU):

  * ``wgrad_plan``: a conv level's weight gradient over ``nsl`` batch
    slices of ``nb`` samples, a block a (tap group of WG_WARPS outputs,
    map, slice) staging bands of ``ny`` output rows; the slices' partials
    added in slice order;
  * ``dgrad_plan``: a conv level's input gradient, a block a (band of
    ``rows`` input rows, input map, sample) on a zero canvas of side ``dp``
    holding the sample's dz dilated by the stride;
  * ``gemm_plan``: a dense product (M, N, K) on 16x16 tiles, K cut into
    ``nks`` slices of ``kslice`` when the tiles are too few for the card,
    the slices added in order.

It also restates the two libraries' workspace carves (``carve`` in
``csrc/megastep.cu`` and ``csrc/megastep_deep.cu``), walks the kernels'
staging and position loops thread by thread, and names the launch limit
the stages' shared memory sets (``stage_limit_reason``), which the route
rule declines by.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["WgradPlan", "DgradPlan", "GemmPlan", "ConvGeom", "wgrad_plan",
           "dgrad_plan", "gemm_plan", "flagship_levels", "deep_levels",
           "flagship_products", "deep_products", "megastep_workspace_floats",
           "deep_workspace_floats", "stage_floats", "wgrad_staging",
           "wgrad_positions", "dgrad_staging", "dgrad_positions",
           "stage_limit_reason"]

SM_COUNT = 132                  # the H100 SXM's SMs
STAGE_FLOATS = 12 * 1024        # 48 KB: the default shared-memory limit
SMEM_OPT_IN = 227 * 1024        # bytes a block can opt in to (sm_90)
TILE = 16                       # a product tile's side
GK = 64                         # K a shared-memory round of a product tile
GEMM_KMIN = 128                 # the shortest slice of K
GEMM_TARGET = 1024              # blocks wanted: ~8 an SM
GEMM_PART_CAP = 1 << 18         # partial floats: the workspace region
WG_WARPS = 8                    # warps a weight-gradient block
WG_THREADS = 32 * WG_WARPS
WG_OPW = 4                      # outputs a warp, at most
WG_TARGET = 3 * SM_COUNT        # blocks wanted
WG_SLICE_TERMS = 2048           # (sample, position) terms a slice
DG_TARGET = 2 * SM_COUNT
DG_MIN_THREADS, DG_MAX_THREADS = 256, 1024
# the fused libraries' other fixed regions (stages.cuh, megastep.cu)
WCOST_BLOCKS = 128
HEAD_KS, HEAD_KB = 64, 256


def cdiv(a, b):
    return -(-a // b)


class ConvGeom(NamedTuple):
    """A conv level for its gradient stages: conv output (y, x) of map m
    (B, M, c, c) reads input row y*cs + F-1-u - pad for tap u (zero off the
    W x W input); the pools' windows cover y, x < e."""
    B: int
    M: int
    Cin: int
    F: int
    c: int
    e: int
    cs: int
    pad: int
    W: int


class WgradPlan(NamedTuple):
    nout: int          # F*F*Cin weights and the bias, a map
    ntg: int           # tap groups of WG_WARPS * opw outputs
    opw: int           # outputs a warp
    nsl: int           # batch slices
    nb: int            # samples a slice (the last may hold fewer)
    nbs: int           # samples staged at a time
    ny: int            # output rows a staged band
    sp: int            # staged input columns, (e-1)*cs + F
    hb: int            # staged input rows of a band
    smem_floats: int

    def grid(self, M):
        return (self.ntg, M, self.nsl)

    def part_floats(self, M):
        return self.nsl * M * self.nout

    def counters(self, M):
        return M * self.ntg

    def slices(self, B):
        """[(first sample, end)] of each slice, in order."""
        return [(s * self.nb, min(B, (s + 1) * self.nb))
                for s in range(self.nsl)]


class DgradPlan(NamedTuple):
    rows: int          # input rows a band
    nbands: int
    dp: int            # canvas side, W + F - 1
    threads: int
    smem_floats: int

    def grid(self, B, Cin):
        return (self.nbands, Cin, B)


class GemmPlan(NamedTuple):
    nks: int
    kslice: int
    part_floats: int

    def ranges(self, K):
        """[(kb, ke)] of each slice of K, in order."""
        return [(s * self.kslice, min(K, (s + 1) * self.kslice))
                for s in range(self.nks)]


def _wgrad_sample_floats(ny, e, cin, f, cs, sp):
    return ny * e + cin * ((ny - 1) * cs + f) * sp


def _wgrad_table_floats(ny, cin, f, cs):
    return 4 * (ny + cin * ((ny - 1) * cs + f))


def wgrad_plan(B, M, Cin, F, e, cs):
    """stages.cuh wgrad_plan."""
    nout = F * F * Cin + 1
    ntg_min = cdiv(nout, WG_WARPS * WG_OPW)
    want = max(cdiv(WG_TARGET, M * ntg_min), cdiv(B * e * e, WG_SLICE_TERMS))
    nsl = min(B, want)
    nb = cdiv(B, nsl)
    nsl = cdiv(B, nb)
    ntg = ntg_min
    if ntg * M * nsl < SM_COUNT:
        ntg = min(cdiv(nout, WG_WARPS), cdiv(SM_COUNT, M * nsl))
    opw = cdiv(nout, ntg * WG_WARPS)
    sp = (e - 1) * cs + F
    ny = e
    while ny > 1 and (_wgrad_table_floats(ny, Cin, F, cs)
                      + _wgrad_sample_floats(ny, e, Cin, F, cs, sp)
                      > STAGE_FLOATS):
        ny -= 1
    fixed = _wgrad_table_floats(ny, Cin, F, cs)
    per = _wgrad_sample_floats(ny, e, Cin, F, cs, sp)
    nbs = 1 if ny < e else max(1, min(nb, (STAGE_FLOATS - fixed) // per))
    hb = (ny - 1) * cs + F
    return WgradPlan(nout, ntg, opw, nsl, nb, nbs, ny, sp, hb,
                     fixed + nbs * per)


def _dgrad_band_floats(rows, M, F, dp):
    return M * F * F + M * (rows + F - 1) * dp


def dgrad_plan(B, Cin, W, M, F):
    """stages.cuh dgrad_plan."""
    dp = W + F - 1
    nb = min(W, max(1, cdiv(DG_TARGET, B * Cin)))
    rows = min(cdiv(W, nb), max(1, DG_MAX_THREADS // W))
    while rows > 1 and _dgrad_band_floats(rows, M, F, dp) > STAGE_FLOATS:
        rows -= 1
    threads = min(DG_MAX_THREADS,
                  max(DG_MIN_THREADS, cdiv(rows * W, 32) * 32))
    return DgradPlan(rows, cdiv(W, rows), dp, threads,
                     _dgrad_band_floats(rows, M, F, dp))


def gemm_plan(M, N, K):
    """stages.cuh gemm_plan."""
    tiles = cdiv(M, TILE) * cdiv(N, TILE)
    nks = min(cdiv(K, GEMM_KMIN), max(1, cdiv(GEMM_TARGET, tiles)))
    nks = min(nks, max(1, GEMM_PART_CAP // (M * N)))
    kslice = cdiv(cdiv(K, nks), GK) * GK
    nks = cdiv(K, kslice)
    return GemmPlan(nks, kslice, nks * M * N if nks > 1 else 0)


# ------------------------------------------------------------- the families


def flagship_levels(spec):
    """The flagship's conv levels for the gradient stages, in the order the
    step runs them: conv2, then conv1 (megastep.cu conv2_geom,
    conv1_geom)."""
    e1 = spec.p1 * spec.pool1 if spec.ib1 else spec.c1
    e2 = spec.p2 * spec.pool2 if spec.ib2 else spec.c2
    return [ConvGeom(spec.batch, spec.maps2, spec.maps1, spec.filt2,
                     spec.c2, e2, 1, 0, spec.p1),
            ConvGeom(spec.batch, spec.maps1, spec.in_ch, spec.filt1,
                     spec.c1, e1, 1, 0, spec.img)]


def _as_deep(spec):
    from .megastep_mlp import MlpSpec, as_deep

    return as_deep(spec) if isinstance(spec, MlpSpec) else spec


def deep_levels(spec):
    """The deep family's conv levels (megastep_deep.cu level_geom), first
    to last; the step runs their gradients last to first."""
    spec = _as_deep(spec)
    out, cin = [], spec.in_ch
    for k, (side, pad, cs, c, po) in enumerate(spec.levels):
        e = po * spec.pools[k] if spec.ibs[k] else c
        out.append(ConvGeom(spec.batch, spec.maps[k], cin, spec.filts[k], c,
                            e, cs, pad, side))
        cin = spec.maps[k]
    return out


def flagship_products(spec):
    """(name, M, N, K) of every product the flagship step runs on gemm."""
    B, NF, NH = spec.batch, spec.n_flat, spec.n_hid
    return [("z3", B, NH, NF), ("dwh", NF, NH, B), ("df", B, NF, NH)]


def deep_products(spec):
    """(name, M, N, K) of every product the deep step runs on gemm, in the
    order of megastep_deep.cu's dense_stages or softaux_stages."""
    spec = _as_deep(spec)
    B, NF, NH, NO = spec.batch, spec.n_flat, spec.n_hid, spec.n_out
    nlev, pre = spec.n_levels, [p[0] for p in spec.pre_hidden]
    if spec.head == "softaux":
        return [("scores", B, NO, NF), ("dwt", NF, NO, B), ("df", B, NF, NO)]
    fw, out = spec.n_tail_in, []
    for j, w in enumerate(pre):
        out.append((f"pre{j}", B, w, fw))
        fw = w
    out += [("z3", B, NH, fw), ("scores", B, NO, NH), ("dwo", NH, NO, B),
            ("dh3", B, NH, NO), ("dwh", fw, NH, B)]
    if nlev or pre:
        out.append(("df", B, fw if pre else NF, NH))
    for j in range(len(pre) - 1, -1, -1):
        inw = pre[j - 1] if j else spec.n_tail_in
        out.append((f"dw_pre{j}", inw, pre[j], B))
        if j or nlev:
            out.append((f"d_pre{j}", B, inw if j else NF, pre[j]))
    return out


def stage_floats(levels):
    """The workspace floats of the stages' regions: the weight gradients'
    slices and counters, one region each as large as the largest level's
    (the levels run one after another); then the products' partials and
    tile counters (a counter is a 32-bit word)."""
    plans = [(wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs), g.M)
             for g in levels]
    return (max([p.part_floats(M) for p, M in plans], default=0)
            + max([p.counters(M) for p, M in plans], default=0)
            + GEMM_PART_CAP + GEMM_TARGET)


def megastep_workspace_floats(spec):
    """csrc/megastep.cu carve(...).total at ``spec`` (a MegaSpec)."""
    B, HW, C0 = spec.batch, spec.hw, spec.in_ch
    M1, M2, NH, NC, NF = (spec.maps1, spec.maps2, spec.n_hid, spec.n_out,
                          spec.n_flat)
    c1, P1, c2 = spec.c1, spec.p1, spec.c2
    n_state = (M1 * spec.filt1 ** 2 * C0 + M1 + M2 * spec.filt2 ** 2 * M1
               + M2 + NF * NH + NH + NH * NC + NC)
    sw = cdiv(B, HEAD_KB)
    return (2 * HW + C0 * B * HW + 2 * B * M1 * c1 * c1 + B * M1 * P1 * P1
            + 2 * B * M2 * c2 * c2 + 2 * B * NF + 3 * B * NH + n_state + 1
            + WCOST_BLOCKS + cdiv(NH, HEAD_KS) * B * NC + B * NC + B
            + (sw * NH * NC if sw > 1 else 0)
            + stage_floats(flagship_levels(spec)))


def deep_workspace_floats(spec):
    """csrc/megastep_deep.cu carve(...).total at ``spec`` (a DeepSpec, or
    an MlpSpec as the flat-MLP family passes it)."""
    from .megastep_deep import deep_kernel_shapes

    spec = _as_deep(spec)
    B, HW, NH, NO = spec.batch, spec.hw, spec.n_hid, spec.n_out
    NC = spec.n_classes or NO
    nah, nao = spec.n_aux or spec.aux_concat or (0, 0)
    NF, NT = spec.n_flat, spec.n_tail_in
    total = 2 * HW + B * spec.in_ch * HW
    for (_, _, _, c, po), m in zip(spec.levels, spec.maps):
        total += 2 * B * m * c * c + 2 * B * m * po * po
    total += sum(4 * B * p[0] for p in spec.pre_hidden)
    total += 4 * B * NH + 2 * B * NO + 2 * B
    total += 3 * B * nah + 3 * B * nao
    total += B * NT if spec.aux_concat else 0
    total += 2 * B * NF if spec.mean_tail else 0
    total += sum(r * c for r, c in deep_kernel_shapes(spec))
    total += 1 + WCOST_BLOCKS + 2 * B
    total += B * NO + B * NC if spec.head == "rbf" else 0
    return total + stage_floats(deep_levels(spec))


# -------------------------------------------------- the staging, thread by thread

WG_RB = 4                       # rows a thread stages at a time (k_wgrad)
DG_RB = 4                       # canvas rows a thread stages at a time


def wgrad_staging(g, p, nbt):
    """The elements a k_wgrad block copies into shared memory in one
    staging pass of ``nbt`` samples, as its threads walk them (a column a
    thread, its rows every rstep, the row decoded once and then stepped):
    [(sample, staged row, column)], a sample's rows its ny dz rows (e wide)
    then Cin x hb input rows (sp wide)."""
    rows_per = p.ny + g.Cin * p.hb
    cw = min(p.sp, WG_THREADS)
    rstep, nrows, out = WG_THREADS // cw, nbt * rows_per, []
    for c0 in range(0, p.sp, cw):
        for tid in range(rstep * cw):
            col, r0 = c0 + tid % cw, tid // cw
            bi, rr = divmod(r0, rows_per)
            r = r0
            while r < nrows:
                for _ in range(WG_RB):
                    if r < nrows and col < (g.e if rr < p.ny else p.sp):
                        out.append((bi, rr, col))
                    r += rstep
                    rr += rstep
                    while rr >= rows_per:
                        rr -= rows_per
                        bi += 1
    return out


def wgrad_positions(e, ny):
    """The staged positions (y, x) of a band of ``ny`` output rows, e wide,
    each lane of a k_wgrad warp sums, as the kernel walks them (a lane
    keeps a column of each chunk of min(e, 32) columns and steps its rows
    by 32 // min(e, 32)): {lane: [(y, x)]}."""
    cwq = min(e, 32)
    rpi = 32 // cwq
    out = {}
    for lane in range(32):
        ly, lx = divmod(lane, cwq)
        if lane >= rpi * cwq:
            continue
        for x0 in range(0, e, cwq):
            x = x0 + lx
            if x >= e:
                break
            out.setdefault(lane, []).extend(
                (y, x) for y in range(ly, ny, rpi))
    return out


def dgrad_staging(g, p, band):
    """The canvas elements (map x row x column, flat) a dgrad block of row
    band ``band`` copies, as its threads walk them (dgrad_stage: of each
    chunk of min(dp, threads) columns a column a thread, its rows every
    threads // that)."""
    nr = min(p.rows, g.W - band * p.rows)
    hr, nrows = nr + g.F - 1, g.M * (nr + g.F - 1)
    cw = min(p.dp, p.threads)
    rstep, out = p.threads // cw, []
    for c0 in range(0, p.dp, cw):
        for tid in range(rstep * cw):
            col, r = c0 + tid % cw, tid // cw
            if col >= p.dp:
                continue
            m, h = divmod(r, hr)
            while r < nrows:
                for _ in range(DG_RB):
                    if r < nrows:
                        out.append(r * p.dp + col)
                    r += rstep
                    h += rstep
                    while h >= hr:
                        h -= hr
                        m += 1
    return out, nrows * p.dp


def dgrad_positions(g, p, band):
    """The band positions (i, j) each dgrad thread sums, as the kernels
    walk them after dgrad_stage (a thread every ``threads`` positions):
    {thread: [(i, j)]}."""
    i0 = band * p.rows
    n = min(p.rows, g.W - i0) * g.W
    return {t: [(i0 + q // g.W, q % g.W) for q in range(t, n, p.threads)]
            for t in range(min(p.threads, n))}


def stage_limit_reason(spec):
    """Why the gradient stages cannot launch at ``spec`` (a MegaSpec, a
    DeepSpec or an MlpSpec), else None: a conv level whose weight- or
    input-gradient staging needs more shared memory, at one row a band,
    than a block can opt in to (csrc/stages.cuh conv_wgrad and the dgrad
    launches return ERR_STAGE_SMEM)."""
    from .megastep import MegaSpec

    if isinstance(spec, MegaSpec):
        levels = flagship_levels(spec)
        dlevels = levels[:1]
    else:
        levels = deep_levels(spec)
        dlevels = levels[1:]
    need = [("weight", k, wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs))
            for k, g in enumerate(levels)]
    need += [("input", k, dgrad_plan(g.B, g.Cin, g.W, g.M, g.F))
             for k, g in enumerate(dlevels)]
    for kind, k, p in need:
        if 4 * p.smem_floats > SMEM_OPT_IN:
            g = (dlevels if kind == "input" else levels)[k]
            return (f"a conv level's {kind}-gradient stage: its {g.W}x{g.W} "
                    f"input, {g.Cin} input maps, {g.M} maps and filter "
                    f"{g.F} stage {4 * p.smem_floats:,} bytes, above the "
                    f"{SMEM_OPT_IN:,} a block can opt in to (csrc/stages.cuh "
                    f"{'wgrad' if kind == 'weight' else 'dgrad'}_plan)")
    return None

"""Launch plans of the fused families' gradient and product stages.

``csrc/stages.cuh`` runs three stage kinds of every fused step on plans
that depend on the shapes alone, so that every sum across blocks runs in
one order on every run and every rank. This module mirrors them line for
line (``chip_smoke.py`` holds each mirror to the C's ``stage_*_plan`` and
``*_workspace_floats`` on the card; tests/test_torch_stage_plan.py pins
them on the CPU):

  * ``wgrad_plan``: a conv level's weight gradient over ``nsl`` slices of
    ``nu`` units (a sample's band of ``ny`` output rows), a block a (slice,
    group of ``mg`` maps) staging its units once for every map and tap,
    each thread a WG_TM x WG_TV tile of outputs; the slices' partials added
    in slice order by clusters of ``cl`` blocks, then the clusters' in
    cluster order;
  * ``wgrad_tile_plan``: the weight gradient of a wide level (where one pass
    of ``wgrad_plan``'s thread tiles does not cover a map group) as an
    output-tiled implicit GEMM, a block a (split of K, tile of ``bm`` maps x
    ``bn`` taps), K in chunks of WT_TK positions staged once for the tile,
    each thread a WT_R x WT_R tile of sums; the ``ns`` splits of a tile
    added in split order by clusters of ``cl`` blocks, then the clusters'
    in cluster order; ``tiled`` 0 where the level keeps ``wgrad_plan``;
  * ``dgrad_plan``: a conv level's input gradient, a block a (band of
    ``rows`` input rows, input map, sample) on a zero canvas of side ``dp``
    holding the sample's dz dilated by the stride;
  * ``dgrad_tile_plan``: the input gradient of a deep level of many input
    maps as a register-tiled implicit GEMM on the same canvas, a block a
    (band, tile of ``cit`` input maps, sample), the maps' depth in chunks
    of ``km`` staged once for the tile; ``tiled`` 0 where the level keeps
    the band path;
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

__all__ = ["WgradPlan", "WgradTilePlan", "DgradPlan", "DgradTilePlan",
           "GemmPlan", "ConvGeom", "wgrad_plan", "wgrad_tile_shape",
           "wgrad_tile_plan", "wgrad_tiled_levels", "wgrad_tile_staging",
           "wgrad_tile_positions", "dgrad_plan", "dgrad_tile_shape",
           "dgrad_tile_plan",
           "dgrad_tiled_levels", "dgrad_tile_staging",
           "dgrad_tile_positions", "gemm_plan", "flagship_levels",
           "deep_levels",
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
WG_TM, WG_TV = 4, 8             # a weight-gradient thread's tile: maps x taps
WG_MAX_THREADS = 256
WG_TARGET = 96                  # slices wanted (a map group's share)
WG_CLUSTER = 8                  # blocks a cluster, at most
WT_TK = 16                      # positions a K chunk of the tiled wgrad
WT_R = 8                        # a tiled wgrad thread's sums: maps x taps
WT_THREADS = 256
WT_MAX_T = 32                   # thread rows (or columns) a tile, at most
WT_TARGET = 2 * SM_COUNT        # blocks wanted: two an SM
WT_MIN_CH = 4                   # chunks a split, at least
WT_STAGE_COST = 4               # a staged float against a product
DG_TARGET = 2 * SM_COUNT
DG_MIN_THREADS, DG_MAX_THREADS = 256, 1024
DT_TCI, DT_TJ = 4, 3            # a tiled thread's sums: input maps x columns
DT_MIN_CIN, DT_FMIN, DT_FMAX = 32, 2, 7
DT_MAX_G, DT_MAX_THREADS, DT_MAX_KM = 8, 512, 16
DT_MIN_WARPS, DT_STAGE_COST = 4, 4
# the fused libraries' other fixed regions (stages.cuh, megastep.cu)
WCOST_BLOCKS = 128
HEAD_KS, HEAD_KB = 64, 256


def cdiv(a, b):
    return -(-a // b)


class ConvGeom(NamedTuple):
    """A conv level for its gradient stages (stages.cuh ConvGeom's fields
    that their plans read): conv output (y, x) of map m (B, M, c, c) reads
    input row y*cs + F-1-u - pad for tap u (zero off the W x W input); the
    pools' windows cover y, x < e."""
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
    mg: int            # maps a block
    ngr: int           # map groups (the grid's y)
    ny: int            # output rows a band
    nbn: int           # bands a sample
    nu: int            # units (a sample's band) a slice
    nbs: int           # units staged at a time
    nsl: int           # slices
    cl: int            # blocks a cluster
    nslp: int          # slices padded to whole clusters (the grid's x)
    hb: int            # staged input rows of a band, (ny-1)*cs + F
    sp: int            # staged input columns, (e-1)*cs + F
    tiles: int         # thread tiles of a map group
    npg: int           # position groups a tile
    threads: int
    passes: int        # tiles a thread takes, one after another
    smem_floats: int

    def grid(self):
        return (self.nslp, self.ngr)

    def n_clusters(self):
        return self.nslp // self.cl

    def part_floats(self, M):
        """The clusters' sums (with several clusters), then the slices'
        (with several passes; else they stay in shared memory)."""
        ncl = self.n_clusters()
        return ((ncl if ncl > 1 else 0) + (self.nslp if self.passes > 1
                                           else 0)) * M * self.nout

    def counters(self):
        """A counter a (map group, cluster rank)."""
        return self.ngr * self.cl

    def units(self, B):
        """[(first unit, end)] of each slice, in order; unit u is band u %
        nbn of sample u // nbn."""
        n = B * self.nbn
        return [(s * self.nu, min(n, (s + 1) * self.nu))
                for s in range(self.nsl)]

    def rounds(self, B, s, e):
        """The staging rounds of slice ``s``: [(sample, first row, rows,
        units)], a round's units whole samples when it holds several."""
        u0, u1 = self.units(B)[s]
        out = []
        for u in range(u0, u1, self.nbs):
            y0 = (u % self.nbn) * self.ny
            out.append((u // self.nbn, y0, min(self.ny, e - y0),
                        min(self.nbs, u1 - u)))
        return out


class WgradTilePlan(NamedTuple):
    tiled: int         # 1: the level takes the tiled path
    tmt: int           # thread rows (maps) of a tile
    tnt: int           # thread columns (taps)
    bm: int            # a tile's maps, WT_R * tmt
    bn: int            # a tile's taps (the bias the last), WT_R * tnt
    bmp: int           # stride of a staged dz row, bm + 4
    bnp: int           # stride of a staged column row, bn + 4
    ntm: int           # tiles along the maps
    ntn: int           # tiles along the taps
    tiles: int         # the grid's y; tile t at maps (t % ntm) * bm, taps
                       # (t // ntm) * bn
    nch: int           # chunks of WT_TK positions in K = B * e * e
    ns: int            # splits of K (the grid's x)
    cl: int            # blocks a cluster
    ncl: int           # clusters a tile
    threads: int
    smem_floats: int

    def grid(self):
        return (self.ns, self.tiles)

    def splits(self):
        """[(first chunk, end)] of each split, in order."""
        return [(s * self.nch // self.ns, (s + 1) * self.nch // self.ns)
                for s in range(self.ns)]

    def origin(self, tile):
        """(first map, first tap) of tile ``tile``."""
        return (tile % self.ntm * self.bm, tile // self.ntm * self.bn)

    def part_floats(self):
        """The clusters' sums, with several clusters."""
        return (self.ncl * self.tiles * self.bm * self.bn if self.ncl > 1
                else 0)

    def counters(self):
        """A counter a (tile, cluster rank), with several clusters."""
        return self.tiles * self.cl if self.ncl > 1 else 0


class DgradPlan(NamedTuple):
    rows: int          # input rows a band
    nbands: int
    dp: int            # canvas side, W + F - 1
    threads: int
    smem_floats: int

    def grid(self, B, Cin):
        return (self.nbands, Cin, B)


class DgradTilePlan(NamedTuple):
    tiled: int         # 1: the level takes the tiled path
    g: int             # DT_TCI-map groups a block
    cit: int           # input maps a tile, DT_TCI * g
    nct: int           # tiles of input maps
    rows: int          # input rows a band
    nbands: int
    nj: int            # DT_TJ-column tiles a row
    dpp: int           # staged canvas columns, nj * DT_TJ + F - 1
    km: int            # maps a chunk
    nch: int           # chunks
    threads: int
    smem_floats: int

    def grid(self, B):
        return (self.nbands, self.nct, B)


class GemmPlan(NamedTuple):
    nks: int
    kslice: int
    part_floats: int

    def ranges(self, K):
        """[(kb, ke)] of each slice of K, in order."""
        return [(s * self.kslice, min(K, (s + 1) * self.kslice))
                for s in range(self.nks)]


def wgrad_unit_floats(ny, mg, e, cin, f, cs):
    """Floats a unit stages: mg maps' dz rows (ny x e), then the cin x hb x
    sp input rows under them."""
    return mg * ny * e + cin * ((ny - 1) * cs + f) * ((e - 1) * cs + f)


def wgrad_plan(B, M, Cin, F, e, cs):
    """stages.cuh wgrad_plan."""
    nout = F * F * Cin + 1
    sp = (e - 1) * cs + F

    def unit(ny, mg):
        return wgrad_unit_floats(ny, mg, e, Cin, F, cs)

    lim = STAGE_FLOATS if unit(1, 1) <= STAGE_FLOATS else SMEM_OPT_IN // 4

    def fits(mg):   # a row's staging; the slice's sums (in global memory
        return unit(1, mg) <= lim and (   # past a pass of tiles)
            cdiv(mg, WG_TM) * cdiv(nout, WG_TV) > WG_MAX_THREADS
            or mg * nout + WG_MAX_THREADS <= lim)

    ngr = 1
    while ngr < M and not fits(cdiv(M, ngr)):
        ngr += 1
    mg = cdiv(M, ngr)
    ngr = cdiv(M, mg)
    want = cdiv(WG_TARGET, ngr)
    ny = e
    while ny > 1 and unit(ny, mg) > lim:
        ny -= 1
    if B < want:
        ny = min(ny, cdiv(e, min(e, cdiv(want, B))))
    nbn = cdiv(e, ny)
    units = B * nbn
    # one wave: at most SM_COUNT blocks, slices padded to whole clusters
    cap = max(1, SM_COUNT // ngr)
    nsl_max = cap if cap <= WG_CLUSTER else cap // WG_CLUSTER * WG_CLUSTER
    nu = max(1, (units + want // 2) // want, cdiv(units, nsl_max))
    nsl = cdiv(units, nu)
    nbs = 1 if nbn > 1 else max(1, min(nu, lim // unit(ny, mg)))
    cl = min(WG_CLUSTER, nsl)
    tiles = cdiv(mg, WG_TM) * cdiv(nout, WG_TV)
    npg = 1
    while 2 * npg * tiles <= WG_MAX_THREADS and npg < nbs * ny * e:
        npg *= 2
    threads = min(WG_MAX_THREADS, cdiv(tiles * npg, 32) * 32)
    passes = cdiv(tiles, threads // npg)
    sums = threads if passes > 1 else mg * nout + threads
    return WgradPlan(nout, mg, ngr, ny, nbn, nu, nbs, nsl, cl,
                     cdiv(nsl, cl) * cl, (ny - 1) * cs + F, sp, tiles, npg,
                     threads, passes, max(nbs * unit(ny, mg), sums))


def wgrad_tile_shape(B, M, Cin, F, e, cs):
    """stages.cuh wgrad_tile_shape: the tiled plan at a level, whichever
    path the level takes."""
    nout = F * F * Cin + 1
    best = None   # (cost, threads, tmt, tnt)
    for tm in range(1, WT_MAX_T + 1):
        tn = 1
        while tn <= WT_MAX_T and tm * tn <= WT_THREADS:
            bm, bn = WT_R * tm, WT_R * tn
            cost = (cdiv(M, bm) * cdiv(nout, bn)
                    * (bm * bn + WT_STAGE_COST * (bm + bn)))
            if (best is None or cost < best[0]
                    or (cost == best[0] and tm * tn > best[1])):
                best = (cost, tm * tn, tm, tn)
            tn += 1
    tmt, tnt = best[2:]
    bm, bn = WT_R * tmt, WT_R * tnt
    ntm, ntn = cdiv(M, bm), cdiv(nout, bn)
    tiles = ntm * ntn
    nch = cdiv(B * e * e, WT_TK)
    ns = min(cdiv(WT_TARGET, tiles), max(1, nch // WT_MIN_CH))
    if ns > WG_CLUSTER:
        ns -= ns % WG_CLUSTER
    cl = min(WG_CLUSTER, ns)
    bmp, bnp = bm + 4, bn + 4
    return WgradTilePlan(1, tmt, tnt, bm, bn, bmp, bnp, ntm, ntn, tiles,
                         nch, ns, cl, ns // cl, WT_THREADS,
                         2 * bn + max(2 * WT_TK * (bmp + bnp), bm * bn))


def wgrad_tile_plan(B, M, Cin, F, e, cs):
    """stages.cuh wgrad_tile_plan: the tiled plan where the level takes
    the tiled path (wgrad_plan's passes > 1), else every field 0
    (k_wgrad on wgrad_plan)."""
    if wgrad_plan(B, M, Cin, F, e, cs).passes <= 1:
        return WgradTilePlan(*[0] * 16)
    return wgrad_tile_shape(B, M, Cin, F, e, cs)


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


def _tile_map_floats(g, rows, F, dpp):
    return F * F * DT_TCI * g + (rows + F - 1) * dpp


def dgrad_tile_shape(B, Cin, W, M, F):
    """stages.cuh dgrad_tile_shape: the tiled plan at a level, whichever
    path the level takes (tiled 0 where no band of one row fits a
    block)."""
    nj = cdiv(W, DT_TJ)
    dpp = nj * DT_TJ + F - 1
    comp = F * (DT_TCI * DT_TJ * F + DT_TJ + 2 * F - 1)
    best = None   # (g, rows, num, den, nb, fill)
    for g in range(1, DT_MAX_G + 1):
        nct = cdiv(Cin, DT_TCI * g)
        r = 1
        while r <= W and g * r * nj <= DT_MAX_THREADS:
            sm = _tile_map_floats(g, r, F, dpp)
            if 8 * sm > SMEM_OPT_IN:
                break
            threads = cdiv(g * r * nj, 32) * 32
            nb = B * nct * cdiv(W, r)
            busiest = cdiv(nb, SM_COUNT) * (threads // 32)
            num = max(busiest, DT_MIN_WARPS) * (comp * threads
                                                + DT_STAGE_COST * sm)
            fill = nb >= SM_COUNT
            if best is None:
                better = True
            elif fill != best[5]:
                better = fill
            elif num * best[3] != best[2] * threads:
                better = num * best[3] < best[2] * threads
            else:
                better = nb < best[4]
            if better:
                best = (g, r, num, threads, nb, fill)
            r += 1
    if best is None:
        return DgradTilePlan(*[0] * 12)
    g, rows = best[:2]
    sm = _tile_map_floats(g, rows, F, dpp)
    km = min(M, DT_MAX_KM, max(1, STAGE_FLOATS // (2 * sm)))
    return DgradTilePlan(1, g, DT_TCI * g, cdiv(Cin, DT_TCI * g), rows,
                         cdiv(W, rows), nj, dpp, km, cdiv(M, km),
                         cdiv(g * rows * nj, 32) * 32, 2 * km * sm)


def dgrad_tile_plan(B, Cin, W, M, F):
    """stages.cuh dgrad_tile_plan: the tiled plan where the level takes
    the tiled path (Cin >= DT_MIN_CIN, filter DT_FMIN to DT_FMAX, a band of
    one row fits), else every field 0 (the band path, dgrad_plan)."""
    if Cin < DT_MIN_CIN or not DT_FMIN <= F <= DT_FMAX:
        return DgradTilePlan(*[0] * 12)
    return dgrad_tile_shape(B, Cin, W, M, F)


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
    step runs them: conv2, then conv1 (megastep.cu make_dims)."""
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
    """The deep family's conv levels (megastep_deep.cu parse), first to
    last; the step runs their gradients last to first."""
    spec = _as_deep(spec)
    out, cin = [], spec.in_ch
    for k, (side, pad, cs, c, po) in enumerate(spec.levels):
        e = po * spec.pools[k] if spec.ibs[k] else c
        out.append(ConvGeom(spec.batch, spec.maps[k], cin, spec.filts[k], c,
                            e, cs, pad, side))
        cin = spec.maps[k]
    return out


def dgrad_tiled_levels(spec):
    """The deep step's input-gradient levels (ConvGeom, every level after
    the first) whose plan takes the tiled path: k_conv_dgrad_tiled
    launches a step (the flagship's conv2 keeps the band path)."""
    from .megastep import MegaSpec

    if isinstance(spec, MegaSpec):
        return []
    return [g for g in deep_levels(spec)[1:]
            if dgrad_tile_plan(g.B, g.Cin, g.W, g.M, g.F).tiled]


def wgrad_tiled_levels(spec):
    """The step's conv levels (ConvGeom, in the order ``flagship_levels``
    or ``deep_levels`` gives them) whose weight-gradient plan takes the
    tiled path: k_wgrad_tiled launches a step."""
    from .megastep import MegaSpec

    levels = (flagship_levels(spec) if isinstance(spec, MegaSpec)
              else deep_levels(spec))
    return [g for g in levels
            if wgrad_tile_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs).tiled]


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
    sums and counters on the path each level takes, one region each as
    large as the largest level's (the levels run one after another); then
    the products' partials and tile counters (a counter is a 32-bit
    word)."""
    parts, ctrs = [0], [0]
    for g in levels:
        t = wgrad_tile_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
        if t.tiled:
            parts.append(t.part_floats())
            ctrs.append(t.counters())
        else:
            p = wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
            parts.append(p.part_floats(g.M))
            ctrs.append(p.counters())
    return max(parts) + max(ctrs) + GEMM_PART_CAP + GEMM_TARGET


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

DG_RB = 4                       # canvas rows a thread stages at a time


def _mixed(i, r0, r1, r2):
    """stages.cuh mixed_of: the digits (d0 < r0, d1 < r1, d2 < r2, d3)."""
    i, d0 = divmod(i, r0)
    i, d1 = divmod(i, r1)
    d3, d2 = divmod(i, r2)
    return [d0, d1, d2, d3]


def _mixed_step(d, s, r0, r1, r2):
    """stages.cuh mixed_step: one carry a digit at most."""
    d = [a + b for a, b in zip(d, s)]
    for k, r in enumerate((r0, r1, r2)):
        if d[k] >= r:
            assert d[k] < 2 * r
            d[k] -= r
            d[k + 1] += 1
    return d


def wgrad_staging(g, p, mgc, nbt, ny):
    """The elements a k_wgrad block copies into shared memory in one
    staging round of ``nbt`` units of ``ny`` output rows for ``mgc`` maps,
    as its threads walk them: each thread two chains of elements, from tid
    and tid + blockDim.x, each stepped 2 blockDim.x by a mixed-radix
    counter of (column, row, map or channel, unit): {'dz': [(unit, map,
    row, column)], 'in': [(unit, channel, row, column)]}."""
    nt, hb = p.threads, (ny - 1) * g.cs + g.F
    lists = {"dz": (nbt * mgc * ny * g.e, (g.e, ny, mgc)),
             "in": (nbt * g.Cin * hb * p.sp, (p.sp, hb, g.Cin))}
    out = {"dz": [], "in": []}
    for name, (n, radix) in lists.items():
        for tid in range(nt):
            d0, d1 = _mixed(tid, *radix), _mixed(tid + nt, *radix)
            step = _mixed(2 * nt, *radix)
            for i in range(tid, n, 2 * nt):
                out[name].append(tuple(reversed(d0)))
                if i + nt < n:
                    out[name].append(tuple(reversed(d1)))
                d0 = _mixed_step(d0, step, *radix)
                d1 = _mixed_step(d1, step, *radix)
    return out


def wgrad_positions(e, ny, nbt, npg):
    """The staged positions (unit, y, x) of a round of ``nbt`` units of
    ``ny`` rows, e wide, each position group of a k_wgrad tile sums, as
    the kernel walks them (group pg takes pg, pg + npg, ..., two a step, by
    a mixed-radix counter): {pg: [(unit, y, x)]}."""
    out = {}
    big = 1 << 30
    qs = _mixed(npg, e, ny, big)
    for pg in range(npg):
        q = _mixed(pg, e, ny, big)
        for _ in range(pg, nbt * ny * e, npg):
            out.setdefault(pg, []).append((q[2], q[1], q[0]))
            q = _mixed_step(q, qs, e, ny, big)
    return out


def wgrad_tile_staging(p):
    """The copies the threads of a k_wgrad_tiled block make in every chunk,
    each thread's in order: two arrays of (thread, shared-memory offset)
    rows, the dz buffer's (position kk, map mm at kk * bmp + mm) and the
    column buffer's (kk, tap nn at kk * bnp + nn). Thread t of warp w, lane
    l stages position kk = 8 (w % 2) + l % 8 and the maps and taps q, q +
    16, ... of q = 4 (w // 2) + l // 8: a warp instruction 8 positions x 4
    maps or taps."""
    import numpy as np

    t = np.arange(p.threads)
    w, ln = t // 32, t % 32
    kk, q = 8 * (w % 2) + ln % 8, 4 * (w // 2) + ln // 8
    out = []
    for width, stride in ((p.bm, p.bmp), (p.bn, p.bnp)):
        j = np.arange(cdiv(width, 16))
        mm = q[:, None] + 16 * j[None, :]
        keep = mm < width
        off = kk[:, None] * stride + mm
        out.append(np.stack([np.broadcast_to(t[:, None], mm.shape)[keep],
                             off[keep]], 1))
    return out[0], out[1]


def wgrad_tile_positions(p):
    """Each computing k_wgrad_tiled thread's place in its tile: {thread:
    (maps, taps)}, the WT_R maps and WT_R taps of the tile whose sums it
    keeps (tm = t % tmt, tn = t // tmt: maps tm*4 + i and bm/2 + tm*4 + i,
    taps tn*4 + j and bn/2 + tn*4 + j, i, j < 4). At position k of a chunk
    it reads the dz buffer at k * bmp + each map and the column buffer at
    k * bnp + each tap."""
    out = {}
    for t in range(p.tmt * p.tnt):
        tm, tn = t % p.tmt, t // p.tmt
        out[t] = (tuple(h * p.bm // 2 + tm * 4 + i for h in (0, 1)
                        for i in range(4)),
                  tuple(h * p.bn // 2 + tn * 4 + j for h in (0, 1)
                        for j in range(4)))
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


def dgrad_tile_staging(g, p, ch):
    """The copies the threads of a k_conv_dgrad_tiled block make in chunk
    ``ch`` (dgrad_tile_stage), each thread's walk in order: two arrays of
    (thread, shared-memory offset) rows, the weights' from the chunk's
    weight buffer and the canvas's from its canvas buffer. Weights: a row
    of cit floats a (map, tap), the thread's column fixed, rows every
    threads // cit; canvas: the band's (row, column) places every threads
    places, each for every map of the chunk in turn."""
    import numpy as np

    nt, cit, hb = p.threads, p.cit, p.rows + g.F - 1
    kmc = min(p.km, g.M - ch * p.km)
    rs = nt // cit
    tid = np.arange(rs * cit)[:, None]
    rows = tid // cit + rs * np.arange(cdiv(kmc * g.F * g.F, rs))[None, :]
    keep = rows < kmc * g.F * g.F
    ws = np.stack([np.broadcast_to(tid, rows.shape)[keep],
                   (rows * cit + tid % cit)[keep]], 1)
    tid = np.arange(nt)[:, None, None]
    place = tid + nt * np.arange(cdiv(hb * p.dpp, nt))[None, :, None]
    off = place + hb * p.dpp * np.arange(kmc)[None, None, :]
    keep = np.broadcast_to(place < hb * p.dpp, off.shape)
    cv = np.stack([np.broadcast_to(tid, off.shape)[keep], off[keep]], 1)
    return ws, cv


def dgrad_tile_positions(g, p):
    """Each k_conv_dgrad_tiled thread's place in its block: {thread:
    (group, band row, column tile)}. Thread t sums the outputs (input map
    ci0 + group*DT_TCI + c, row i0 + band row, column tile*DT_TJ + q), c <
    DT_TCI, q < DT_TJ, reading for map mk of a chunk the weights at mk*F*F
    *cit + (u*F + v)*cit + group*DT_TCI + c and the canvas at (mk*hb +
    band row + u)*dpp + tile*DT_TJ + k, k < DT_TJ + F - 1."""
    P = p.rows * p.nj
    return {t: (t // P, t % P // p.nj, t % P % p.nj)
            for t in range(p.g * P)}


def stage_limit_reason(spec):
    """Why the gradient stages cannot launch at ``spec`` (a MegaSpec, a
    DeepSpec or an MlpSpec), else None: a conv level whose weight- or
    input-gradient staging needs more shared memory, at one row a band (and
    for the weight gradient one map a block), than a block can opt in to (csrc/stages.cuh conv_wgrad and the dgrad
    launches return ERR_STAGE_SMEM). Each level is judged by the path its
    plans select; a tiled plan always fits."""
    from .megastep import MegaSpec

    if isinstance(spec, MegaSpec):
        levels = flagship_levels(spec)
        dlevels = levels[:1]
    else:
        levels = deep_levels(spec)
        dlevels = levels[1:]

    def dgrad(g):   # the plan of the path the level takes
        p = dgrad_tile_plan(g.B, g.Cin, g.W, g.M, g.F)
        if p.tiled and not isinstance(spec, MegaSpec):
            return p
        return dgrad_plan(g.B, g.Cin, g.W, g.M, g.F)

    def wgrad(g):   # the plan of the path the level takes
        p = wgrad_tile_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)
        return p if p.tiled else wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs)

    need = [("weight", k, wgrad(g)) for k, g in enumerate(levels)]
    need += [("input", k, dgrad(g)) for k, g in enumerate(dlevels)]
    for kind, k, p in need:
        if 4 * p.smem_floats > SMEM_OPT_IN:
            g = (dlevels if kind == "input" else levels)[k]
            return (f"a conv level's {kind}-gradient stage: its {g.W}x{g.W} "
                    f"input, {g.Cin} input maps, {g.M} maps and filter "
                    f"{g.F} stage {4 * p.smem_floats:,} bytes, above the "
                    f"{SMEM_OPT_IN:,} a block can opt in to (csrc/stages.cuh "
                    f"{'wgrad' if kind == 'weight' else 'dgrad'}_plan)")
    return None

// Whole-epoch fused training of conv stacks of any depth and of flat nets,
// for Hopper (sm_90a).
//
// Replaces theanet_tpu/ops/megastep_deep.py::_kernel_deep (body
// _deep_fwd_bwd), at a zero-level table megastep_mlp.py::_kernel_mlp, and,
// at the deep family, megastep_dp.py::_kernel_grad.
// Its plain PyTorch twin, the specification this file is held to, is
// theanet_tpu_torch/ops/megastep_deep.py::deep_epoch_reference.
//
// What it computes, per step of the epoch, for [Color ->] Input/Elastic ->
// (Conv -> [Pool])*n -> [AuxConcat ->] (Hidden -> [DropOut])*m -> Softmax |
// Hinge | ExpLoss | CenteredOut, or (Conv -> [Pool])*n -> SoftAux: the
// color jitter and elastic augmentation from the injected bits; every conv
// level (true convolution, 'valid' at any stride, 'same' or 'full' by
// zero padding, read directly at y*stride + f-1-u - pad; activation;
// max-pool of any size with or without ignore_border, or the identity
// pool); a MeanLayer flatten (the per-map mean of the last pooled level,
// k_mean_fwd / k_mean_bwd); the LocationInfo aux
// encoder on the step's (B, 4) aux rows (convex mix with u from dropout
// lane 0, 2 -> nah leaky .5 -> nao leaky .01), whose output AuxConcat
// appends to the flatten and SoftAux adds to its scores through the cross
// weights; the dense tail with dropout masks from the step's dropout words
// (pre-hidden j reads lanes [off_j, off_j + width_j), starting at lane 1
// after AuxConcat's draw, the final hidden the last n_hid lanes); the head
// (log-softmax with loss nll, nllsq or nll clamped at log_thresh, the
// whole-matrix hinge on the raw scores, exp(-score) on row-centred scores,
// LOGIT bit probabilities, or RBF distances by the expansion ||v||^2 -
// 2 v.c + ||c||^2 with a junk column in the partition sum); the
// hand-derived backward through all of it (pool gradients reach every tied
// maximum; AuxConcat's frozen encoder gets none); then L1/L2 gradients,
// the old-accumulator momentum step and max-norm of every state tensor.
//
// What bounds it on the card. At galaxy_rbf's shapes (batch 20, 3 x 28 x 28,
// maps 8/16, hidden 200, 32 RBF features) a step is ~10 M multiply-adds and
// depends on the previous step's parameters, so, as for the flagship, the
// epoch is bound by the latency of its dependent stages, not by FLOPs or
// bytes; flat_mlp (784 x 1000 hidden) moves most bytes in its dense
// products, still far below the card's rate at batch 20.
//
// What the design does about it: the flagship kernel's design,
// parameterised at run time. One C call per epoch loops the steps on the
// caller's stream; a level table (input maps, maps, filter, input side,
// conv side, pooled side, pool, ignore_border, activation, pad, conv
// stride, slope) drives, per level, the conv+pool and pool-backward
// stages the flagship runs too (stages.cuh k_conv_pool, k_pool_bwd, after
// k_augment), one weight-gradient stage (stages.cuh conv_wgrad: fixed
// batch slices, a block a slice staging its rows once for every map and
// tap, the slices added in order by clusters; at a level of many outputs
// an output-tiled implicit GEMM, k_wgrad_tiled) and one input-gradient stage
// (a block a row band, input map and sample on the sample's dz dilated by
// the stride onto a zero canvas; at a level of many input maps a
// register-tiled implicit GEMM on the same canvas, k_conv_dgrad_tiled)
// per level (a padded or strided level reads its input directly); the
// dense stages loop over the
// pre-hidden stack and then the final hidden, each product on stages.cuh
// gemm (16x16 tiles, K cut into slices added in order when the tiles are
// too few for the card; the bias, activation and dropout ride in the pass
// that writes the product); a head stage of one block a sample the
// softmax-kind, LOGIT or RBF loss down to dL/dscores, a grid stage the
// cost, the scores bias's gradient and (learned RBF centers) dcenters,
// each in one fixed order with no atomics;
// the aux encoder is one single-block stage forward (k_aux_fwd) and one
// backward (k_aux_bwd, SoftAux only): its widths are a few units; the
// weight cost is a two-pass grid reduction; one update launch covers every
// state tensor. Conv sums are tap by tap in the kernel layout's order with
// separately rounded multiplies and adds, as in the twin: which pool
// windows tie exactly depends on that order. Nothing is computed by a
// library kernel.
//
// Data-parallel training splits a step in two entries that run the epoch's
// own helpers: deep_grad_step runs grad_stages (k_warp through the last
// conv weight gradient) at the per-rank batch into a caller-owned flat
// gradient buffer, and deep_update runs update_stages (k_update and the
// max-norm kernels) on it after the caller's all-reduce. The epoch loop
// calls the same two helpers, so the two paths cannot drift apart.
//
// deep_ring_epoch, the whole-epoch data-parallel entry (the port of
// theanet_tpu/ops/megastep_ring.py::_kernel_ring at the deep family, flat
// nets at zero levels), is the epoch loop with the exchange of
// csrc/ring.cuh between grad_stages and update_stages: one C call an epoch
// a rank; learned RBF centers are one more tensor of the exchanged set.

#include <atomic>

#include "stages.cuh"
#include "ring.cuh"

namespace {

// ---- integer spec (order fixed by theanet_tpu_torch/ops/_build.py): the
// header, then N_ILEV ints per conv level, N_IPRE per pre-hidden layer and
// N_ITEN per state tensor
enum {
  I_B, I_C0, I_H, I_NLEV, I_NPRE, I_NH, I_NO, I_NC, I_HEAD, I_ACTH, I_COLOR,
  I_INVERT, I_NEAREST, I_TRANS, I_MAG, I_ZOOM, I_ANGLE, I_LEARNC, I_FBL,
  I_DBL, I_NSTATE, I_LOSS, I_NAH, I_NAO, I_AUXCAT, I_MEAN, N_IHEAD
};
enum {
  L_CIN, L_M, L_F, L_S, L_C, L_P, L_POOL, L_IB, L_ACT, L_PAD, L_CS, N_ILEV
};
enum { H_W, H_ACT, N_IPRE };
enum { T_SIZE, T_KIND, T_ROWS, T_COLS, N_ITEN };
// ---- float spec: the header, then 1 per level (slope), 2 per pre-hidden
// layer (slope, pdrop) and N_REG per state tensor
enum {
  F_SLOPEH, F_PDROP, F_TRANS, F_LOGZOOM, F_MAG, F_PFLIP, F_ANGLE, F_CLIPHI,
  F_LOGBAL, F_LOGGAM, F_MAXVAL, F_INVMAX, F_JUNK, F_BOOST, F_LOGTHRESH,
  N_FHEAD
};
// ---- pointer table: then n_state params, n_state moms, cost_minf. AUXW is
// AuxConcat's frozen encoder (w1, b1, w2, b2 packed), AUX the (n_steps, B,
// 4) aux rows; both null when the net has none
enum {
  P_X, P_Y, P_UB, P_FB, P_PB, P_DB, P_GH, P_GW, P_CENTERS, P_AUXW, P_AUX,
  P_STATE
};

constexpr int MAX_LEVELS = 8, MAX_PRE = 8;
constexpr int HEAD_SOFTMAX = 0, HEAD_LOGIT = 1, HEAD_RBF = 2,
              HEAD_SOFTAUX = 3;
// a softmax-kind head's loss, in the order of ops/_build.py LOSS_KINDS
constexpr int LOSS_NLL = 0, LOSS_NLLSQ = 1, LOSS_NLLT = 2, LOSS_HINGE = 3,
              LOSS_EXP = 4;
constexpr int KIND_ROWS = 0, KIND_COLS = 1, KIND_BIAS = 2;
constexpr float LOGIT_EPS = 0.001f;
// deep_conv_dgrad asked for the tiled path at a level whose plan has none
constexpr int ERR_NOT_TILED = -6;

struct Pre {
  int w, act;
  float slope, pdrop;
};

struct Net {
  int B, C0, H, HW, nlev, npre, NH, NO, NC, head, acth, learnc, fbl, dbl,
      nstate, NF, loss, nah, nao, auxcat, NT,   // NT: the dense tail's input
      mean;   // a MeanLayer flatten: NF = the last level's maps
  float slopeh, pdrop, junk, boost, logthresh;
  ConvGeom lv[MAX_LEVELS];   // stages.cuh: level 0 reads the augmented
                             // image (B, C0, H, H), the others the
                             // pooled output before them
  Pre pre[MAX_PRE];
  const int* ten;     // N_ITEN ints per state tensor
  const float* reg;   // N_REG floats per state tensor
};

// 0, or a negative code for deep_error_string.
int parse(const int* is, const float* fs, Net* n) {
  n->B = is[I_B]; n->C0 = is[I_C0]; n->H = is[I_H]; n->HW = n->H * n->H;
  n->nlev = is[I_NLEV]; n->npre = is[I_NPRE]; n->NH = is[I_NH];
  n->NO = is[I_NO]; n->NC = is[I_NC]; n->head = is[I_HEAD];
  n->acth = is[I_ACTH]; n->learnc = is[I_LEARNC]; n->fbl = is[I_FBL];
  n->dbl = is[I_DBL]; n->nstate = is[I_NSTATE]; n->loss = is[I_LOSS];
  n->nah = is[I_NAH]; n->nao = is[I_NAO]; n->auxcat = is[I_AUXCAT];
  n->mean = is[I_MEAN];
  n->slopeh = fs[F_SLOPEH]; n->pdrop = fs[F_PDROP]; n->junk = fs[F_JUNK];
  n->boost = fs[F_BOOST]; n->logthresh = fs[F_LOGTHRESH];
  if (n->nlev > MAX_LEVELS || n->npre > MAX_PRE) return -3;
  if (n->nstate > MAX_TENSORS) return -3;
  const int* li = is + N_IHEAD;
  const float* lf = fs + N_FHEAD;
  for (int k = 0; k < n->nlev; ++k, li += N_ILEV, ++lf)
    n->lv[k] = conv_level(n->B, li[L_CIN], li[L_M], li[L_F], li[L_S],
                          li[L_C], li[L_P], li[L_POOL], li[L_IB], li[L_PAD],
                          li[L_CS], li[L_ACT], lf[0]);
  for (int j = 0; j < n->npre; ++j, li += N_IPRE, lf += 2) {
    n->pre[j].w = li[H_W]; n->pre[j].act = li[H_ACT];
    n->pre[j].slope = lf[0]; n->pre[j].pdrop = lf[1];
  }
  n->ten = li;
  n->reg = lf;
  if (n->nlev) {
    const ConvGeom& L = n->lv[n->nlev - 1];
    n->NF = n->mean ? L.M : L.M * L.p * L.p;
  } else {
    n->NF = n->C0 * n->HW;
  }
  n->NT = n->NF + (n->auxcat ? n->nao : 0);
  return 0;
}

// Input gradient of a conv level into the previous level's pooled
// gradient (B, Cin, S, S): stages.cuh dgrad_stage / dgrad_sum, a block a
// (row band, input map, sample), a thread a position; the taps in the
// order m, u, v (at stride 1 and pad 0 the valid conv's sum, term for
// term).
__global__ void k_conv_dgrad(ConvGeom g, DgradPlan p,
                             const float* __restrict__ w,
                             const float* __restrict__ dz,
                             float* __restrict__ din) {
  const int n = dgrad_stage(g, p, w, dz);
  float* out = din + (((size_t)blockIdx.z * g.Cin + blockIdx.y) * g.W
                      + (size_t)blockIdx.x * p.rows) * g.W;
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    out[t] = dgrad_sum(g, p, t);
}

// The input gradient of a wide level (stages.cuh dgrad_tile_plan) as a
// register-tiled FP32 implicit GEMM: din[b, ci, i, j] = sum over (m, u,
// v), in that order, of w[m, (u*F+v)*Cin + ci] * dzd[b, m, i+u, j+v] on
// the band path's zero canvas dzd.
//
// It replaces no TPU kernel of its own: it is a stage of the backward of
// theanet_tpu/ops/megastep_deep.py::_kernel_deep, as k_conv_dgrad is, and
// the level's plan picks one of the two.
//
// What bounds it on the card: operations. At the GTSRB column's levels 2
// and 3 at batch 20 (100 -> 150 maps at 21 x 21, 150 -> 250 at 9 x 9,
// filter 4) a step's valid input gradient is 3.98 GFLOP, 59 us at 67
// TFLOP/s in f32 (6.18 GFLOP on the canvas, taps on its zero border
// included), against about 12 MB of dz, weights and din (4 us at 3.35
// TB/s).
//
// What the design does about it: k_conv_dgrad, a block a (row band, input
// map, sample), stages its sample's dz of every map once for each input
// map (about 700 and 2,400 copies of each dz float at the column's two
// levels, 4.5 GB a step from L2) and sums on one or two warps a block.
// Here a block takes a tile of cit input maps and a band of rows of one
// sample, and stages each chunk of km maps' canvas rows once for the whole
// tile, with the chunk's weights of its input maps (both by cp.async, the
// next chunk's copies in flight while the block sums the current one).
// Each thread keeps a DT_TCI x DT_TJ tile of sums in registers: a row of
// DT_TJ + F - 1 canvas values serves its F taps along j for DT_TCI input
// maps, and a float4 of weights its DT_TJ positions. Each output's sum
// stays in one thread, one FMA a tap in the order m, u, v (the band
// path's contracted multiply-add), so the two paths give the same bits.
// FP32 on the CUDA cores: no TF32. Levels of few input maps keep the band
// path, whose one wide launch of short sums is their latency floor
// (stages.cuh, above dgrad_tile_plan). On an H100 SXM (700 W) the
// column's two levels take about 165 and 146 us a launch at batch 20 (the
// band path 2,880 and 2,130): the sums alone 147 and 96, the rest the
// staging at level 3; the sums are held by the shared-memory reads a
// 4 x 3 tile needs for each FMA.

// Chunk ``ch``'s copies into buffer ``buf`` (stages.cuh layout: the two
// weight buffers, then the two canvas buffers): the weights a row of cit
// floats (m, u, v), a thread's column ci fixed, rows every threads / cit;
// the canvas a (row, column) place of the band every threads places, each
// place for every map of the chunk (its source and whether it lies on the
// stride lattice worked out once a place, not once a copy). Zero fills
// past Cin, off the canvas and off the stride lattice.
__device__ __forceinline__ void dgrad_tile_stage(
    const ConvGeom& g, const DgradTilePlan& p, const float* __restrict__ w,
    const float* __restrict__ dz, int ch, int buf, int b, int ci0, int i0) {
  extern __shared__ float sm[];
  const int F = g.F, FF = F * F, cit = p.cit, hb = p.rows + F - 1;
  const int tid = threadIdx.x, nt = blockDim.x, dpp = p.dpp;
  const int m0 = ch * p.km, kmc = min(p.km, g.M - m0);
  float* ws = sm + buf * p.km * FF * cit;
  float* cv = sm + 2 * p.km * FF * cit + buf * p.km * hb * dpp;
  const int rs = nt / cit, cl = tid % cit;
  const bool ciok = ci0 + cl < g.Cin;
  const float* wsrc = w + (size_t)m0 * FF * g.Cin + ci0 + (ciok ? cl : 0);
  if (tid < rs * cit) {
    const float* src = wsrc + (size_t)(tid / cit) * g.Cin;
    const size_t sstep = (size_t)rs * g.Cin;
    float* dst = ws + tid;   // row tid / cit, column cl
    for (int row = tid / cit; row < kmc * FF;
         row += rs, src += sstep, dst += rs * cit)
      cp_float(dst, src, ciok);
  }
  const int off = F - 1 - g.pad, cs = g.cs, cc = g.c * g.c;
  const float* dzb = dz + ((size_t)b * g.M + m0) * cc;
  for (int q = tid; q < hb * dpp; q += nt) {
    const int h = q / dpp, col = q - h * dpp;
    const int X = col - off, Y = i0 + h - off;   // x * cs, y * cs
    const int x = cs == 1 ? X : X / cs, y = cs == 1 ? Y : Y / cs;
    const bool ok = X >= 0 && Y >= 0 && x < g.e && y < g.e
                    && (cs == 1 || (X % cs == 0 && Y % cs == 0));
    const float* src = ok ? dzb + (size_t)y * g.c + x : dz;
    const int step = ok ? cc : 0;
    float* dst = cv + h * dpp + col;
    for (int mk = 0; mk < kmc; ++mk, dst += hb * dpp, src += step)
      cp_float(dst, src, ok);
  }
}

template <int F>
__global__ void __launch_bounds__(DT_MAX_THREADS)
k_conv_dgrad_tiled(ConvGeom g, DgradTilePlan p, const float* __restrict__ w,
                   const float* __restrict__ dz, float* __restrict__ din) {
  pdl_wait();   // started by programmatic dependent launch
  pdl_trigger();
  extern __shared__ float sm[];
  constexpr int FF = F * F, ND = DT_TJ + F - 1;
  const int b = blockIdx.z, ci0 = blockIdx.y * p.cit;
  const int i0 = blockIdx.x * p.rows, hb = p.rows + F - 1, dpp = p.dpp;
  const int P = p.rows * p.nj, t = threadIdx.x;
  const bool active = t < p.g * P;
  const int gi = t / P, pos = t % P, r = pos / p.nj, jt = pos % p.nj;
  float acc[DT_TCI][DT_TJ];
#pragma unroll
  for (int c = 0; c < DT_TCI; ++c)
#pragma unroll
    for (int q = 0; q < DT_TJ; ++q) acc[c][q] = 0.0f;
  dgrad_tile_stage(g, p, w, dz, 0, 0, b, ci0, i0);
  cp_commit();
  for (int ch = 0; ch < p.nch; ++ch) {
    if (ch + 1 < p.nch) {
      dgrad_tile_stage(g, p, w, dz, ch + 1, (ch + 1) & 1, b, ci0, i0);
      cp_commit();
      cp_wait_group<1>();
    } else {
      cp_wait_group<0>();
    }
    __syncthreads();
    if (active) {
      const int kmc = min(p.km, g.M - ch * p.km);
      const float* wp = sm + (ch & 1) * p.km * FF * p.cit + gi * DT_TCI;
      const float* cp = sm + 2 * p.km * FF * p.cit
                        + ((ch & 1) * p.km * hb + r) * dpp + jt * DT_TJ;
      for (int mk = 0; mk < kmc; ++mk, wp += FF * p.cit, cp += hb * dpp) {
#pragma unroll
        for (int u = 0; u < F; ++u) {
          float d[ND];
#pragma unroll
          for (int k = 0; k < ND; ++k) d[k] = cp[u * dpp + k];
#pragma unroll
          for (int v = 0; v < F; ++v) {
            const float4 wv =
                *reinterpret_cast<const float4*>(wp + (u * F + v) * p.cit);
            const float wc[DT_TCI] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int c = 0; c < DT_TCI; ++c)
#pragma unroll
              for (int q = 0; q < DT_TJ; ++q)
                acc[c][q] = fmaf(wc[c], d[q + v], acc[c][q]);
          }
        }
      }
    }
    __syncthreads();   // the buffer is restaged by the chunk after next
  }
  const int i = i0 + r;
  if (!active || i >= g.W) return;
#pragma unroll
  for (int c = 0; c < DT_TCI; ++c) {
    const int ci = ci0 + gi * DT_TCI + c;
    if (ci >= g.Cin) break;
    float* out = din + (((size_t)b * g.Cin + ci) * g.W + i) * g.W;
#pragma unroll
    for (int q = 0; q < DT_TJ; ++q) {
      const int j = jt * DT_TJ + q;
      if (j < g.W) out[j] = acc[c][q];
    }
  }
}

// A level's input gradient on the tiled path (its plan's tiled set).
template <int F>
int conv_dgrad_tiled_f(cudaStream_t s, const ConvGeom& g,
                       const DgradTilePlan& p, const float* w,
                       const float* dz, float* din) {
  const size_t smem = sizeof(float) * p.smem_floats;
  if (!smem_opt_in(k_conv_dgrad_tiled<F>, smem)) return ERR_STAGE_SMEM;
  CHECK(launch_pdl(k_conv_dgrad_tiled<F>, dim3(p.nbands, p.nct, g.B),
                   dim3(p.threads), smem, s, g, p, w, dz, din));
  return 0;
}

// Tiled launches issued since the library was loaded (the epoch wrappers
// read the count around each call: deep_dgrad_tiled_launches).
std::atomic<long long> dgrad_tiled_launched{0};

// A conv level's input gradient on the path its plan selects: the band
// path (k_conv_dgrad) or, at a wide level, the tiled one; ``tiled``
// forces the path (0 band, 1 tiled; -1 the plan's choice). 0, or a
// negative code or CUDA error.
int conv_dgrad(cudaStream_t s, const ConvGeom& g, const float* w,
               const float* dz, float* din, int tiled = -1) {
  const DgradTilePlan tp =
      tiled == 0 ? DgradTilePlan{} : dgrad_tile_plan(g.B, g.Cin, g.W, g.M, g.F);
  if (tiled == 1 && !tp.tiled) return ERR_NOT_TILED;
  if (tp.tiled) {
    int rc;
    switch (g.F) {
      case 2: rc = conv_dgrad_tiled_f<2>(s, g, tp, w, dz, din); break;
      case 3: rc = conv_dgrad_tiled_f<3>(s, g, tp, w, dz, din); break;
      case 4: rc = conv_dgrad_tiled_f<4>(s, g, tp, w, dz, din); break;
      case 5: rc = conv_dgrad_tiled_f<5>(s, g, tp, w, dz, din); break;
      case 6: rc = conv_dgrad_tiled_f<6>(s, g, tp, w, dz, din); break;
      default: rc = conv_dgrad_tiled_f<7>(s, g, tp, w, dz, din); break;
    }
    if (rc == 0) ++dgrad_tiled_launched;
    return rc;
  }
  const DgradPlan dg = dgrad_plan(g.B, g.Cin, g.W, g.M, g.F);
  const size_t dsm = sizeof(float) * dg.smem_floats;
  if (!smem_opt_in(k_conv_dgrad, dsm)) return ERR_STAGE_SMEM;
  CHECK(launch_pdl(k_conv_dgrad, dim3(dg.nbands, g.Cin, g.B),
                   dim3(dg.threads), dsm, s, g, dg, w, dz, din));
  return 0;
}

// The MeanLayer flatten: f[b, m] = sum over the last level's pn x pn
// pooled positions, in row-major order, of p * (1/pn^2) (the twin's
// order); one thread per (b, m).
__global__ void k_mean_fwd(int BM, int PP, const float* __restrict__ p,
                           float* __restrict__ f) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= BM) return;
  const float inv = 1.0f / (float)PP;
  const float* row = p + (size_t)q * PP;
  float s = __fmul_rn(row[0], inv);
  for (int k = 1; k < PP; ++k) s = __fadd_rn(s, __fmul_rn(row[k], inv));
  f[q] = s;
}

// Its backward: every position of (b, m) gets df[b, m] * (1/pn^2).
__global__ void k_mean_bwd(int BM, int PP, const float* __restrict__ df,
                           float* __restrict__ dp) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= BM * PP) return;
  dp[e] = __fmul_rn(df[e / PP], 1.0f / (float)PP);
}

// The dropout mask of element (b, n) of a dense layer: kept when its word's
// uniform is at least pdrop.
__device__ __forceinline__ bool kept(const int* db, int dbl, int off, int b,
                                     int n, float pdrop) {
  return !(pdrop > 0.0f) || u01(db[b * dbl + off + n]) >= pdrop;
}

// A pre-hidden layer's backward below its output: dz = dh * mask * act'(z)
// and the bias gradient, one thread per column.
__global__ void k_dense_bwd(int B, int W, int act, float slope, float pdrop,
                            const int* __restrict__ db, int dbl, int off,
                            const float* __restrict__ z,
                            const float* __restrict__ dh,
                            float* __restrict__ dz, float* __restrict__ gb) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= W) return;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) {
    float g = dh[b * W + n];
    if (!kept(db, dbl, off, b, n, pdrop)) g = 0.0f * g;
    float d = g * dact_fn(z[b * W + n], act, slope);
    dz[b * W + n] = d;
    s += d;
  }
  gb[n] = s;
}

// The LocationInfo encoder's tensors: its weights (AuxConcat's frozen
// constants or SoftAux's state) and its activations in the workspace.
struct AuxEnc {
  int nah, nao;
  float boost;
  const float *w1, *b1, *w2, *b2;
  float *x2, *z1, *h1, *z2, *h2;
};

// The encoder's forward in one block (its widths are a few units): x2 =
// (a[:, 0:2] u + a[:, 2:4] (1 - u)) boost with u from dropout lane 0, z1 =
// x2 w1 + b1, h1 = leaky .5, z2 = h1 w2 + b2, h2 = leaky .01. For SoftAux
// (``cw`` given) it then adds the aux logits to the scores in place:
// z4 = (z4 + cb) + h2 cw, z4 holding f Wt + bt (megastep_deep.py:1367-1376).
__global__ void k_aux_fwd(int B, AuxEnc e, const float* __restrict__ aux,
                          const int* __restrict__ db, int dbl,
                          const float* __restrict__ cw,
                          const float* __restrict__ cb, int NC,
                          float* __restrict__ z4) {
  const int tid = threadIdx.x, nt = blockDim.x, nah = e.nah, nao = e.nao;
  for (int q = tid; q < B * 2; q += nt) {
    const int b = q / 2, i = q % 2;
    const float u = u01(db[b * dbl]);
    e.x2[q] = (aux[b * 4 + i] * u + aux[b * 4 + 2 + i] * (1.0f - u))
              * e.boost;
  }
  __syncthreads();
  for (int q = tid; q < B * nah; q += nt) {
    const int b = q / nah, j = q % nah;
    const float z = (e.x2[2 * b] * e.w1[j] + e.x2[2 * b + 1] * e.w1[nah + j])
                    + e.b1[j];
    e.z1[q] = z;
    e.h1[q] = act_fn(z, ACT_LEAKY, 0.5f);
  }
  __syncthreads();
  for (int q = tid; q < B * nao; q += nt) {
    const int b = q / nao, k = q % nao;
    float acc = 0.0f;
    for (int j = 0; j < nah; ++j) acc += e.h1[b * nah + j] * e.w2[j * nao + k];
    const float z = acc + e.b2[k];
    e.z2[q] = z;
    e.h2[q] = act_fn(z, ACT_LEAKY, 0.01f);
  }
  if (!cw) return;
  __syncthreads();
  for (int q = tid; q < B * NC; q += nt) {
    const int b = q / NC, c = q % NC;
    float acc = 0.0f;
    for (int k = 0; k < nao; ++k) acc += e.h2[b * nao + k] * cw[k * NC + c];
    z4[q] = (z4[q] + cb[c]) + acc;
  }
}

// AuxConcat: the dense tail's input [f || h2], (B, NF + nao).
__global__ void k_concat(int B, int NF, int nao, const float* __restrict__ f,
                         const float* __restrict__ h2,
                         float* __restrict__ out) {
  const int W = NF + nao;
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B * W) return;
  const int b = q / W, j = q % W;
  out[q] = j < NF ? f[b * NF + j] : h2[b * nao + j - NF];
}

// SoftAux's backward through the aux logits and the encoder, in one block
// (megastep_deep.py:1401-1415): from dz4 (B, NC) the gradients of cw, w2,
// b2, w1, b1, and cb's, which is bt's (``gbt``, written by k_head_reduce).
// ``dz2`` and ``dz1`` are scratch.
__global__ void k_aux_bwd(int B, AuxEnc e, int NC,
                          const float* __restrict__ dz4,
                          const float* __restrict__ cw,
                          const float* __restrict__ gbt,
                          float* __restrict__ dz2, float* __restrict__ dz1,
                          float* __restrict__ gw1, float* __restrict__ gb1,
                          float* __restrict__ gw2, float* __restrict__ gb2,
                          float* __restrict__ gcw, float* __restrict__ gcb) {
  const int tid = threadIdx.x, nt = blockDim.x, nah = e.nah, nao = e.nao;
  for (int q = tid; q < nao * NC; q += nt) {   // dcw = h2^T dz4
    const int k = q / NC, c = q % NC;
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) acc += e.h2[b * nao + k] * dz4[b * NC + c];
    gcw[q] = acc;
  }
  for (int c = tid; c < NC; c += nt) gcb[c] = gbt[c];
  for (int q = tid; q < B * nao; q += nt) {    // dz2 = (dz4 cw^T) act'
    const int b = q / nao, k = q % nao;
    float acc = 0.0f;
    for (int c = 0; c < NC; ++c) acc += dz4[b * NC + c] * cw[k * NC + c];
    dz2[q] = acc * dact_fn(e.z2[q], ACT_LEAKY, 0.01f);
  }
  __syncthreads();
  for (int q = tid; q < nah * nao; q += nt) {  // dw2 = h1^T dz2
    const int j = q / nao, k = q % nao;
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) acc += e.h1[b * nah + j] * dz2[b * nao + k];
    gw2[q] = acc;
  }
  for (int k = tid; k < nao; k += nt) {
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) acc += dz2[b * nao + k];
    gb2[k] = acc;
  }
  for (int q = tid; q < B * nah; q += nt) {    // dz1 = (dz2 w2^T) act'
    const int b = q / nah, j = q % nah;
    float acc = 0.0f;
    for (int k = 0; k < nao; ++k) acc += dz2[b * nao + k] * e.w2[j * nao + k];
    dz1[q] = acc * dact_fn(e.z1[q], ACT_LEAKY, 0.5f);
  }
  __syncthreads();
  for (int q = tid; q < 2 * nah; q += nt) {    // dw1 = x2^T dz1
    const int i = q / nah, j = q % nah;
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) acc += e.x2[2 * b + i] * dz1[b * nah + j];
    gw1[q] = acc;
  }
  for (int j = tid; j < nah; j += nt) {
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) acc += dz1[b * nah + j];
    gb1[j] = acc;
  }
}

struct HeadArgs {
  int B, NO, NC, kind, loss;
  float junk, logthresh;
};

// The head's loss down to dL/dscores, one block a sample (b = blockIdx.x):
// the sample's row of scores z4 (NO of them, read from L2; for SoftAux f Wt
// + bt + cb + h2a cw) and its label. It writes dz4's row, the sample's term
// of the loss sum tl[b] and its watchdog value mf[b]: the true-class
// log-probability or, for hinge and exp, the true-class score, raw or
// row-centred (megastep.py:1513-1563, 1660-1686); LOGIT the raw sigmoid of
// the true class's feature, RBF its feature 1.7 tanh(2/3 z) (the class
// clamped to the feature width). Each per-class loop is a block
// reduction. RBF: the sample's features v to hv, its row of -dists by the
// expansion -((||v||^2 - 2 v.c) + ||c||^2) (a warp a class), the
// log-softmax with the junk column in the partition sum, dL/d dists to
// hdd's row, then dz4 through the features, 2 (v rs - dd cen) 1.7 (2/3)
// (1 - t^2). A label outside [0, NC) gives a NaN term.
__global__ void __launch_bounds__(HEAD_T)
k_head_loss(HeadArgs h, const float* __restrict__ z4,
            const float* __restrict__ cen, const int* __restrict__ y,
            float* __restrict__ dz4, float* __restrict__ tl,
            float* __restrict__ mf, float* __restrict__ hv,
            float* __restrict__ hdd) {
  pdl_trigger();
  __shared__ float red[32];
  const int b = blockIdx.x, B = h.B, NO = h.NO, NC = h.NC;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float invB = 1.0f / (float)B;
  const int yb = y[b];
  const bool ok = yb >= 0 && yb < NC;
  const int yc = max(0, min(yb, NO - 1));   // the watchdog's feature
  const float* zb = z4 + (size_t)b * NO;
  float* gb = dz4 + (size_t)b * NO;

  if (h.kind == HEAD_SOFTMAX || h.kind == HEAD_SOFTAUX) {
    if (h.loss == LOSS_HINGE) {   // the mean over the whole (B, NC) matrix
      const float ts = ok ? zb[yb] : NAN, inv = 1.0f / (float)(B * NO);
      float ls = 0.0f, ms = 0.0f;
      for (int c = tid; c < NO; c += nt) {
        const float marg = zb[c] + 1.0f - ts;
        ls += fmaxf(marg, 0.0f);
        ms += marg > 0.0f ? 1.0f : 0.0f;
      }
      ls = block_sum(ls, red);
      ms = block_sum(ms, red);
      for (int c = tid; c < NO; c += nt) {
        const float m = zb[c] + 1.0f - ts > 0.0f ? 1.0f : 0.0f;
        gb[c] = (m - (c == yb ? ms : 0.0f)) * inv;
      }
      if (tid == 0) { tl[b] = ls; mf[b] = ts; }
      return;
    }
    if (h.loss == LOSS_EXP) {     // on the row-centred scores
      float mean = 0.0f;
      for (int c = tid; c < NO; c += nt) mean += zb[c];
      mean = block_sum(mean, red) / (float)NO;
      const float ts = ok ? zb[yb] - mean : NAN, e = expf(-ts);
      for (int c = tid; c < NO; c += nt)
        gb[c] = (e * invB) * (1.0f / (float)NO - (c == yb ? 1.0f : 0.0f));
      if (tid == 0) { tl[b] = e; mf[b] = ts; }
      return;
    }
    float mx = -INFINITY;
    for (int c = tid; c < NO; c += nt) mx = fmaxf(mx, zb[c]);
    mx = block_extreme<false>(mx, red);
    float se = 0.0f;
    for (int c = tid; c < NO; c += nt) se += expf(zb[c] - mx);
    const float lse = logf(block_sum(se, red));
    const float t = ok ? (zb[yb] - mx) - lse : NAN;
    const float gate = h.logthresh - t > 0.0f ? 1.0f : 0.0f;
    for (int c = tid; c < NO; c += nt) {
      const float p = expf((zb[c] - mx) - lse), oh = c == yb ? 1.0f : 0.0f;
      gb[c] = h.loss == LOSS_NLLSQ ? (2.0f * t * invB) * (oh - p)
              : h.loss == LOSS_NLLT ? (gate * invB) * (p - oh)
                                    : (p - oh) * invB;
    }
    if (tid == 0) {
      tl[b] = h.loss == LOSS_NLLSQ ? t * t
              : h.loss == LOSS_NLLT ? fmaxf(0.0f, h.logthresh - t) : -t;
      mf[b] = t;
    }
    return;
  }
  if (h.kind == HEAD_LOGIT) {
    // features squeezed into [eps, 1-eps]; bit probabilities against the
    // true class's center row
    float s = 0.0f;
    for (int f = tid; f < NO; f += nt) {
      const float sg = 1.0f / (1.0f + expf(-zb[f]));
      const float vf = sg * (1.0f - 2.0f * LOGIT_EPS) + LOGIT_EPS;
      const float c = ok ? cen[yb * NO + f] : NAN;
      const float bp = c * vf + (1.0f - c) * (1.0f - vf);
      s += logf(bp);
      gb[f] = (1.0f - 2.0f * c) / ((float)B * bp)
              * (1.0f - 2.0f * LOGIT_EPS) * sg * (1.0f - sg);
    }
    s = block_sum(s, red);
    if (tid == 0) {
      tl[b] = -(ok ? s : NAN);
      mf[b] = 1.0f / (1.0f + expf(-zb[yc]));
    }
    return;
  }
  // RBF: the junk column joins the partition sum only
  float* vb = hv + (size_t)b * NO;
  float* db_ = hdd + (size_t)b * NC;
  float sv = 0.0f;
  for (int f = tid; f < NO; f += nt) {
    const float v = 1.7f * tanhf(zb[f] * (2.0f / 3.0f));
    vb[f] = v;
    sv += v * v;
  }
  const float ssv = block_sum(sv, red);   // syncs: vb is written
  const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  for (int c = wid; c < NC; c += nw) {    // -dists, by the expansion
    float dot = 0.0f, cc = 0.0f;
    for (int f = lane; f < NO; f += 32) {
      const float cf = cen[c * NO + f];
      dot += vb[f] * cf;
      cc += cf * cf;
    }
    dot = warp_sum(dot);
    cc = warp_sum(cc);
    if (lane == 0) db_[c] = -((ssv - 2.0f * dot) + cc);
  }
  __syncthreads();
  float mx = -h.junk;
  for (int c = tid; c < NC; c += nt) mx = fmaxf(mx, db_[c]);
  mx = block_extreme<false>(mx, red);
  float se = 0.0f;
  for (int c = tid; c < NC; c += nt) se += expf(db_[c] - mx);
  const float lse = logf(block_sum(se, red) + expf(-h.junk - mx));
  if (tid == 0 && !ok) tl[b] = NAN;
  float r = 0.0f;
  for (int c = tid; c < NC; c += nt) {
    const float lp = db_[c] - mx - lse;
    if (c == yb) tl[b] = -lp;
    const float g = -((expf(lp) - (c == yb ? 1.0f : 0.0f)) * invB);
    db_[c] = g;
    r += g;
  }
  const float rs = block_sum(r, red);     // syncs: db_ holds dL/d dists
  for (int f = tid; f < NO; f += nt) {    // through the features
    float s = 0.0f;
    for (int c = 0; c < NC; ++c) s += db_[c] * cen[c * NO + f];
    const float tf = tanhf(zb[f] * (2.0f / 3.0f));
    const float dv = 2.0f * (vb[f] * rs - s);
    gb[f] = dv * 1.7f * (2.0f / 3.0f) * (1.0f - tf * tf);
  }
  if (tid == 0) mf[b] = vb[yc];
}

// What needs the whole batch, spread over blocks of COLSUM_THREADS: block
// 0 the cost, sum(tl) / (B, or B NC for hinge) + the weight cost, and
// min(mf); then NO/32 blocks of the scores bias's gradient (column sums of
// dz4, block_colsum32); for learned RBF centers a thread an element of
// dcenters = 2 (cen colsum(dd) - dd^T v), each summed over the batch in
// order.
__global__ void __launch_bounds__(COLSUM_THREADS)
k_head_reduce(HeadArgs h, const float* __restrict__ tl,
              const float* __restrict__ mf, const float* __restrict__ dz4,
              const float* __restrict__ cen, const float* __restrict__ hv,
              const float* __restrict__ hdd,
              const float* __restrict__ wcost, float* __restrict__ gbo,
              float* __restrict__ gcen, float* __restrict__ cm) {
  pdl_wait();
  __shared__ float red[32];
  const int B = h.B, NO = h.NO, NC = h.NC;
  int blk = blockIdx.x;
  if (blk == 0) {
    float s = 0.0f, mn = INFINITY;
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      s += tl[b];
      mn = fminf(mn, mf[b]);
    }
    s = block_sum(s, red);
    mn = block_extreme<true>(mn, red);
    if (threadIdx.x == 0) {
      const bool hinge = (h.kind == HEAD_SOFTMAX || h.kind == HEAD_SOFTAUX)
                         && h.loss == LOSS_HINGE;
      cm[0] = s / (float)(hinge ? B * NC : B) + (wcost ? wcost[0] : 0.0f);
      cm[1] = mn;
    }
    return;
  }
  blk -= 1;
  const int nbo = (NO + 31) / 32;
  if (blk < nbo) {
    block_colsum32(B, NO, dz4, blk * 32, gbo);
    return;
  }
  const int e = (blk - nbo) * blockDim.x + threadIdx.x;
  if (e >= NC * NO) return;
  const int c = e / NO, f = e % NO;
  float cs = 0.0f, s = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float g = hdd[(size_t)b * NC + c];
    cs += g;
    s += g * hv[(size_t)b * NO + f];
  }
  gcen[e] = 2.0f * (cen[e] * cs - s);
}

struct Workspace {
  float *tyx, *a, *grads, *wcost, *wpart;
  float *z[MAX_LEVELS], *p[MAX_LEVELS], *dz[MAX_LEVELS], *dp[MAX_LEVELS];
  float *pz[MAX_PRE], *phd[MAX_PRE], *pdh[MAX_PRE], *pdz[MAX_PRE];
  float *z3, *h3d, *z4, *dz4, *dh3, *dz3;
  float *x2, *z1a, *h1a, *z2a, *h2a, *dz1a, *dz2a, *fcat;   // aux encoder
  float *fmean, *dmean;   // the MeanLayer flatten and its gradient
  float* df;   // where the tail's input gradient lands: the flatten's
  float *tl, *mf, *hv, *hdd;   // the head's per-sample terms and watchdog
                               // values; RBF features and dL/d dists
  float *wgparts, *gparts;   // the conv weight gradients' slices, the
                             // products' K slices
  unsigned* ctr;   // the products' tile counters, then the weight
  long long nctr;  // gradients' (zeroed at each entry: zero_counters)
  long long total;
};

Workspace carve(const Net& n, float* base) {
  Workspace w;
  long long o = 0;
  auto take = [&](long long k) { float* p = base ? base + o : nullptr; o += k; return p; };
  const long long B = n.B;
  w.tyx = take(2LL * n.HW);
  w.a = take(B * n.C0 * n.HW);
  for (int k = 0; k < n.nlev; ++k) {
    const ConvGeom& L = n.lv[k];
    w.z[k] = take(B * L.M * L.c * L.c);
    w.dz[k] = take(B * L.M * L.c * L.c);
    w.p[k] = take(B * L.M * L.p * L.p);
    w.dp[k] = take(B * L.M * L.p * L.p);
  }
  for (int j = 0; j < n.npre; ++j) {
    w.pz[j] = take(B * n.pre[j].w);
    w.phd[j] = take(B * n.pre[j].w);
    w.pdh[j] = take(B * n.pre[j].w);
    w.pdz[j] = take(B * n.pre[j].w);
  }
  w.z3 = take(B * n.NH);
  w.h3d = take(B * n.NH);
  w.z4 = take(B * n.NO);
  w.dz4 = take(B * n.NO);
  w.dh3 = take(B * n.NH);
  w.dz3 = take(B * n.NH);
  w.x2 = take(B * 2);
  w.z1a = take(B * n.nah);
  w.h1a = take(B * n.nah);
  w.dz1a = take(B * n.nah);
  w.z2a = take(B * n.nao);
  w.h2a = take(B * n.nao);
  w.dz2a = take(B * n.nao);
  w.fcat = take(n.auxcat ? B * n.NT : 0);
  w.fmean = take(n.mean ? B * n.NF : 0);
  w.dmean = take(n.mean ? B * n.NF : 0);
  w.df = n.mean ? w.dmean : n.nlev ? w.dp[n.nlev - 1] : nullptr;
  long long np = 0;
  for (int t = 0; t < n.nstate; ++t) np += n.ten[t * N_ITEN + T_SIZE];
  w.grads = take(np);
  w.wcost = take(1);
  w.wpart = take(WCOST_BLOCKS);
  w.tl = take(B);
  w.mf = take(B);
  w.hv = take(n.head == HEAD_RBF ? B * n.NO : 0);
  w.hdd = take(n.head == HEAD_RBF ? B * n.NC : 0);
  long long nwg = 0, nwc = 0;   // the levels run one after another: one
  for (int k = 0; k < n.nlev; ++k) {   // region
    nwg = std::max(nwg, wgrad_part_floats(n.lv[k]));
    nwc = std::max(nwc, wgrad_counters(n.lv[k]));
  }
  w.wgparts = take(nwg);
  w.gparts = take(GEMM_PART_CAP);
  w.nctr = GEMM_TARGET + nwc;
  w.ctr = (unsigned*)take(w.nctr);
  w.total = o;
  return w;
}

// One step's slice of the data and noise words.
struct StepIn {
  const float *x, *aux;   // aux: the step's (B, 4) rows or null
  const int *y, *ub, *fb, *pb, *db;
};

// What every step of a call shares: the parsed net, the workspace, the
// augmentation and head settings, the parameters and the weight-cost table.
struct StepCtx {
  Net n;
  Workspace w;
  WarpParams wp;
  AugParams ag;
  HeadArgs ha;
  AuxEnc enc;   // the aux encoder of an AuxConcat or SoftAux net
  size_t warp_smem;
  const float *gh, *gw, *cen;
  float* prm[MAX_TENSORS];
  WcostTable wt;
  bool any_wcost;
  int th, dboff;
};

// 0, or a negative code (deep_error_string). ``centers`` are the frozen
// CenteredOut centers (unused otherwise); learned ones are the last state
// tensor of ``prm``.
int step_setup(const int* is, const float* fs, float* ws, const float* gh,
               const float* gw, const float* centers, const float* auxw,
               void* const* prm, StepCtx* c) {
  int rc = parse(is, fs, &c->n);
  if (rc != 0) return rc;
  const Net& n = c->n;
  c->w = carve(n, ws);
  c->gh = gh;
  c->gw = gw;
  c->wt.count = n.nstate;
  c->any_wcost = false;
  for (int t = 0; t < n.nstate; ++t) {
    const float* r = n.reg + t * N_REG;
    c->prm[t] = (float*)prm[t];
    c->wt.p[t] = c->prm[t];
    c->wt.n[t] = n.ten[t * N_ITEN + T_SIZE];
    c->wt.L1[t] = r[R_L1];
    c->wt.L2[t] = r[R_L2];
    c->any_wcost = c->any_wcost || r[R_L1] != 0.0f || r[R_L2] != 0.0f;
  }
  // the head's tensors follow the convs' and the pre-hiddens'
  c->th = 2 * n.nlev + 2 * n.npre;   // wh; then bh, wo, bo(, cen)
  c->cen = n.learnc ? c->prm[c->th + 4] : centers;
  WarpParams& wp = c->wp;
  wp.trans = is[I_TRANS]; wp.mag = is[I_MAG]; wp.zoom = is[I_ZOOM];
  wp.angle = is[I_ANGLE];
  wp.translation = fs[F_TRANS]; wp.logzoom = fs[F_LOGZOOM];
  wp.magnitude = fs[F_MAG]; wp.angle_rad = fs[F_ANGLE];
  wp.clip_hi = fs[F_CLIPHI];
  AugParams& ag = c->ag;
  ag.warp = wp.trans || wp.mag || wp.zoom || wp.angle;
  ag.nearest = is[I_NEAREST]; ag.invert = is[I_INVERT];
  ag.color = is[I_COLOR]; ag.pflip = fs[F_PFLIP]; ag.maxval = fs[F_MAXVAL];
  ag.inv_maxval = fs[F_INVMAX];
  ag.logbal = fs[F_LOGBAL]; ag.loggam = fs[F_LOGGAM];
  c->warp_smem = 4 * sizeof(float) * (size_t)n.HW;
  if (ag.warp && !warp_smem_ok(c->warp_smem)) return -1;
  c->ha.B = n.B; c->ha.NO = n.NO; c->ha.NC = n.NC; c->ha.kind = n.head;
  c->ha.junk = n.junk; c->ha.loss = n.loss; c->ha.logthresh = n.logthresh;
  c->dboff = n.dbl - n.NH;   // the final hidden's dropout lanes
  AuxEnc& e = c->enc;
  e.nah = n.nah; e.nao = n.nao; e.boost = n.boost;
  if (n.head == HEAD_SOFTAUX) {   // [Wt, bt, w1, b1, w2, b2, cw, cb]
    e.w1 = c->prm[c->th + 2]; e.b1 = c->prm[c->th + 3];
    e.w2 = c->prm[c->th + 4]; e.b2 = c->prm[c->th + 5];
  } else if (n.auxcat) {          // the packed frozen constants
    e.w1 = auxw; e.b1 = auxw + 2 * n.nah;
    e.w2 = e.b1 + n.nah; e.b2 = e.w2 + n.nah * n.nao;
  }
  e.x2 = c->w.x2; e.z1 = c->w.z1a; e.h1 = c->w.h1a; e.z2 = c->w.z2a;
  e.h2 = c->w.h2a;
  return 0;
}

// The head on the step's scores w.z4: k_head_loss, a block a sample, then
// k_head_reduce.
cudaError_t launch_head(const StepCtx& c, cudaStream_t s, const float* cen,
                        const int* y, float* gbo, float* gcen, float* cm) {
  const Workspace& w = c.w;
  const HeadArgs& h = c.ha;
  const float* wc = c.any_wcost ? w.wcost : nullptr;
  k_head_loss<<<h.B, HEAD_T, 0, s>>>(h, w.z4, cen, y, w.dz4, w.tl, w.mf,
                                     w.hv, w.hdd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  int nblk = 1 + (h.NO + 31) / 32;
  if (h.kind == HEAD_RBF && gcen)
    nblk += (h.NC * h.NO + COLSUM_THREADS - 1) / COLSUM_THREADS;
  return launch_pdl(k_head_reduce, dim3(nblk), dim3(COLSUM_THREADS), s, h,
                    w.tl, w.mf, w.dz4, cen, w.hv, w.hdd, wc, gbo, gcen, cm);
}

// SoftAux head on the flatten f (B, NF), forward and backward: the scores
// f Wt + bt, the aux logits (k_aux_fwd), the loss (launch_head), the encoder's
// and cross weights' gradients (k_aux_bwd), dWt and df into w.df (the
// last level's pooled gradient, or the MeanLayer flatten's).
int softaux_stages(const StepCtx& c, cudaStream_t s, const StepIn& in,
                   const float* f, float* const* grad, float* cm) {
  const Net& n = c.n;
  const Workspace& w = c.w;
  float* const* prm = c.prm;
  const int th = c.th, B = n.B, NC = n.NO, NF = n.NF;
  CHECK((gemm<false, false>(s, B, NC, NF, f, NF, prm[th], NC,
                            gemm_out(w.z4, NC, prm[th + 1]), w.gparts, w.ctr)));
  k_aux_fwd<<<1, 256, 0, s>>>(B, c.enc, in.aux, in.db, n.dbl, prm[th + 6],
                              prm[th + 7], NC, w.z4);
  LAUNCHED();
  if (c.any_wcost) CHECK(wcost(s, c.wt, w.wpart, w.wcost));
  CHECK(launch_head(c, s, nullptr, in.y, grad[th + 1], nullptr, cm));
  k_aux_bwd<<<1, 256, 0, s>>>(B, c.enc, NC, w.dz4, prm[th + 6], grad[th + 1],
                              w.dz2a, w.dz1a, grad[th + 2], grad[th + 3],
                              grad[th + 4], grad[th + 5], grad[th + 6],
                              grad[th + 7]);
  LAUNCHED();
  CHECK((gemm<true, false>(s, NF, NC, B, f, NF, w.dz4, NC,
                           gemm_out(grad[th], NC), w.gparts, w.ctr)));
  return (int)gemm<false, true>(s, B, NF, NC, w.dz4, NC, prm[th], NC,
                                gemm_out(w.df, NF), w.gparts, w.ctr);
}

// [AuxConcat ->] the pre-hiddens, the final hidden and a softmax-kind or
// CenteredOut head on the flatten f (B, NF), forward and backward; df
// (its first NF columns: AuxConcat's frozen encoder takes no gradient)
// lands in the gradient buffer below the tail.
int dense_stages(const StepCtx& c, cudaStream_t s, const StepIn& in,
                 const float* f, float* const* grad, float* cm) {
  const Net& n = c.n;
  const Workspace& w = c.w;
  float* const* prm = c.prm;
  const int th = c.th, dboff = c.dboff, T = 256, B = n.B;
  const bool need_df = n.nlev > 0 || n.npre > 0;
  int fw = n.NF, off = 0;
  if (n.auxcat) {   // [f || encoder(aux)]; the mix reads dropout lane 0
    k_aux_fwd<<<1, 256, 0, s>>>(B, c.enc, in.aux, in.db, n.dbl, nullptr,
                                nullptr, 0, nullptr);
    LAUNCHED();
    k_concat<<<blocks((long long)B * n.NT, T), T, 0, s>>>(B, n.NF, n.nao, f,
                                                          w.h2a, w.fcat);
    LAUNCHED();
    f = w.fcat;
    fw = n.NT;
    off = 1;
  }
  const float* tail_in = f;
  for (int j = 0; j < n.npre; ++j) {
    const Pre& P = n.pre[j];
    const int t = 2 * n.nlev + 2 * j;
    CHECK((gemm<false, false>(s, B, P.w, fw, f, fw, prm[t], P.w,
                              hidden_out(w.pz[j], P.w, prm[t + 1], w.phd[j],
                                         P.act, P.slope, P.pdrop, in.db,
                                         n.dbl, off), w.gparts, w.ctr)));
    f = w.phd[j];
    fw = P.w;
    off += P.w;
  }
  CHECK((gemm<false, false>(s, B, n.NH, fw, f, fw, prm[th], n.NH,
                            hidden_out(w.z3, n.NH, prm[th + 1], w.h3d,
                                       n.acth, n.slopeh, n.pdrop, in.db,
                                       n.dbl, dboff), w.gparts, w.ctr)));
  CHECK((gemm<false, false>(s, B, n.NO, n.NH, w.h3d, n.NH, prm[th + 2],
                            n.NO, gemm_out(w.z4, n.NO, prm[th + 3]),
                            w.gparts, w.ctr)));
  if (c.any_wcost) CHECK(wcost(s, c.wt, w.wpart, w.wcost));
  CHECK(launch_head(c, s, c.cen, in.y, grad[th + 3],
                    n.learnc ? grad[th + 4] : nullptr, cm));
  // dwo = h3d^T dz4; dz3 = (dz4 wo^T) * mask * act'(z3), dbh
  CHECK((gemm<true, false>(s, n.NH, n.NO, B, w.h3d, n.NH, w.dz4, n.NO,
                           gemm_out(grad[th + 2], n.NO), w.gparts, w.ctr)));
  CHECK((gemm<false, true>(s, B, n.NH, n.NO, w.dz4, n.NO, prm[th + 2],
                           n.NO, gemm_out(w.dh3, n.NH), w.gparts, w.ctr)));
  k_dense_bwd<<<blocks(n.NH, T), T, 0, s>>>(
      B, n.NH, n.acth, n.slopeh, n.pdrop, in.db, n.dbl, dboff, w.z3, w.dh3,
      w.dz3, grad[th + 1]);
  LAUNCHED();
  // backward through the dense tail: dwh = f^T dz3; df = dz3 wh^T lands
  // in the gradient buffer of f (the last pre-hidden's output or w.df,
  // the flatten's NF columns)
  CHECK((gemm<true, false>(s, fw, n.NH, B, f, fw, w.dz3, n.NH,
                           gemm_out(grad[th], n.NH), w.gparts, w.ctr)));
  if (need_df) {
    float* dst = n.npre ? w.pdh[n.npre - 1] : w.df;
    const int nd = n.npre ? fw : n.NF;
    CHECK((gemm<false, true>(s, B, nd, n.NH, w.dz3, n.NH, prm[th], n.NH,
                             gemm_out(dst, nd), w.gparts, w.ctr)));
  }
  for (int j = n.npre - 1; j >= 0; --j) {
    const Pre& P = n.pre[j];
    const int t = 2 * n.nlev + 2 * j;
    off -= P.w;
    const float* fin = j ? w.phd[j - 1] : tail_in;
    const int inw = j ? n.pre[j - 1].w : n.NT;
    k_dense_bwd<<<blocks(P.w, T), T, 0, s>>>(
        B, P.w, P.act, P.slope, P.pdrop, in.db, n.dbl, off, w.pz[j],
        w.pdh[j], w.pdz[j], grad[t + 1]);
    LAUNCHED();
    CHECK((gemm<true, false>(s, inw, P.w, B, fin, inw, w.pdz[j], P.w,
                             gemm_out(grad[t], P.w), w.gparts, w.ctr)));
    if (j || n.nlev) {
      float* dst = j ? w.pdh[j - 1] : w.df;
      const int nd = j ? inw : n.NF;
      CHECK((gemm<false, true>(s, B, nd, P.w, w.pdz[j], P.w, prm[t], P.w,
                               gemm_out(dst, nd), w.gparts, w.ctr)));
    }
  }
  return 0;
}

// One step's augmentation, forward and hand-derived backward at the
// parameters of ``c``: (cost, minf) to cm[0:2] and the data gradients (no
// L1/L2 term, no update) of every state tensor to the flat buffer
// ``grads``, back to back in layout order. The epoch entry and the
// data-parallel step entry both run it.
int grad_stages(const StepCtx& c, cudaStream_t s, const StepIn& in,
                float* grads, float* cm) {
  const Net& n = c.n;
  const Workspace& w = c.w;
  float* const* prm = c.prm;
  float* grad[MAX_TENSORS];
  for (int t = 0; t < n.nstate; ++t) {
    grad[t] = grads;
    grads += n.ten[t * N_ITEN + T_SIZE];
  }
  const int T = 256, B = n.B, HW = n.HW;
  if (c.ag.warp) {
    k_warp<<<1, 256, c.warp_smem, s>>>(n.H, c.wp, in.ub, in.fb, c.gh, c.gw,
                                        w.tyx);
    LAUNCHED();
  }
  k_augment<<<blocks((long long)B * n.C0 * HW, T), T, 0, s>>>(
      B, n.C0, n.H, c.ag, in.x, w.tyx, in.fb, in.pb, w.a);
  LAUNCHED();
  // forward: conv levels
  const float* inp = w.a;
  for (int k = 0; k < n.nlev; ++k) {
    const ConvGeom& L = n.lv[k];
    k_conv_pool<<<blocks((long long)B * L.M * L.p * L.p, T), T, 0, s>>>(
        L, inp, prm[2 * k], prm[2 * k + 1], w.z[k], w.p[k]);
    LAUNCHED();
    inp = w.p[k];
  }
  const ConvGeom* last = n.nlev ? &n.lv[n.nlev - 1] : nullptr;
  if (n.mean) {
    k_mean_fwd<<<blocks((long long)B * last->M, T), T, 0, s>>>(
        B * last->M, last->p * last->p, inp, w.fmean);
    LAUNCHED();
    inp = w.fmean;
  }
  // the head, the dense tail and their backward down to the flatten
  int rc = n.head == HEAD_SOFTAUX ? softaux_stages(c, s, in, inp, grad, cm)
                                  : dense_stages(c, s, in, inp, grad, cm);
  if (rc != 0) return rc;
  if (n.mean) {
    k_mean_bwd<<<blocks((long long)B * last->M * last->p * last->p, T), T, 0,
                 s>>>(B * last->M, last->p * last->p, w.dmean,
                      w.dp[n.nlev - 1]);
    LAUNCHED();
  }
  // backward through the conv levels
  for (int k = n.nlev - 1; k >= 0; --k) {
    const ConvGeom& g = n.lv[k];
    k_pool_bwd<<<blocks((long long)B * g.M * g.c * g.c, T), T, 0, s>>>(
        g, w.z[k], w.p[k], w.dp[k], w.dz[k]);
    LAUNCHED();
    const float* lin = k ? w.p[k - 1] : w.a;
    rc = conv_wgrad(s, g, w.dz[k], lin, w.wgparts, w.ctr + GEMM_TARGET,
                    grad[2 * k], grad[2 * k + 1]);
    if (rc != 0) return rc;
    if (k) {
      rc = conv_dgrad(s, g, prm[2 * k], w.dz[k], w.dp[k - 1]);
      if (rc != 0) return rc;
    }
  }
  return 0;
}

// L1/L2 gradient, old-accumulator momentum step and max-norm of every
// state tensor from the flat gradient buffer ``grads``, in place. The
// epoch entry and the data-parallel update entry both run it.
int update_stages(const Net& n, float* const* prm, float* const* mom,
                  const float* grads, float lr, cudaStream_t s) {
  const int NS = n.nstate;
  UpdateTable ut;
  ut.count = NS;
  ut.off[0] = 0;
  for (int t = 0; t < NS; ++t) {
    const int* ti = n.ten + t * N_ITEN;
    const float* r = n.reg + t * N_REG;
    ut.p[t] = prm[t];
    ut.a[t] = mom[t];
    ut.g[t] = grads + ut.off[t];
    ut.off[t + 1] = ut.off[t] + ti[T_SIZE];
    ut.L1[t] = r[R_L1];
    ut.L2x2[t] = r[R_L2X2];
    ut.mom[t] = r[R_MOM];
    ut.omm[t] = r[R_OMM];
    ut.rate[t] = r[R_RATE];
    ut.clip[t] = ti[T_KIND] == KIND_BIAS ? r[R_MAXNORM] : 0.0f;
  }
  const int T = 256;
  k_update<<<blocks(ut.off[NS], T), T, 0, s>>>(ut, lr);
  LAUNCHED();
  for (int t = 0; t < NS; ++t) {   // weight max-norm (biases clipped)
    const int* ti = n.ten + t * N_ITEN;
    const float* r = n.reg + t * N_REG;
    if (r[R_MAXNORM] == 0.0f || r[R_RATE] == 0.0f) continue;
    if (ti[T_KIND] == KIND_ROWS) {
      k_maxnorm_rows<<<ti[T_ROWS], T, 0, s>>>(prm[t], ti[T_COLS],
                                              r[R_MAXNORM]);
    } else if (ti[T_KIND] == KIND_COLS) {
      k_maxnorm_cols<<<blocks(ti[T_COLS], T), T, 0, s>>>(
          prm[t], ti[T_ROWS], ti[T_COLS], r[R_MAXNORM]);
    } else {
      continue;
    }
    LAUNCHED();
  }
  return 0;
}

// Whether a net with an aux layer lacks its aux rows (or AuxConcat its
// encoder) in the pointer table.
bool aux_missing(const Net& n, void* const* ptrs) {
  const bool has_aux = n.head == HEAD_SOFTAUX || n.auxcat;
  return (has_aux && !ptrs[P_AUX]) || (n.auxcat && !ptrs[P_AUXW]);
}

// The epoch loop of deep_epoch (``R`` null) and deep_ring_epoch:
// grad_stages, at a data-parallel rank the ring exchange (into the
// workspace's gradient buffer and cost_minf), then update_stages, a step.
int epoch_loop(const int* is, const float* fs, void* const* ptrs,
               int n_steps, float lr, float* ws, Ring* R, int device,
               cudaStream_t s) {
  CHECK(cudaSetDevice(device));
  StepCtx c;
  int rc = step_setup(is, fs, ws, (const float*)ptrs[P_GH],
                      (const float*)ptrs[P_GW],
                      (const float*)ptrs[P_CENTERS],
                      (const float*)ptrs[P_AUXW], ptrs + P_STATE, &c);
  if (rc != 0) return rc;
  const Net& n = c.n;
  if (aux_missing(n, ptrs)) return -4;
  CHECK(zero_counters(c.w.ctr, c.w.nctr, s));
  const int NS = n.nstate, B = n.B, HW = n.HW;
  float* mom[MAX_TENSORS];
  for (int t = 0; t < NS; ++t) mom[t] = (float*)ptrs[P_STATE + NS + t];
  float* cm = (float*)ptrs[P_STATE + 2 * NS];
  long long ng = 0;
  for (int t = 0; t < NS; ++t) ng += n.ten[t * N_ITEN + T_SIZE];
  const bool ring = R && R->n > 1;
  for (int st = 0; st < n_steps; ++st) {
    StepIn in;
    in.x = (const float*)ptrs[P_X] + (size_t)st * n.C0 * B * HW;
    in.y = (const int*)ptrs[P_Y] + (size_t)st * B;
    in.ub = (const int*)ptrs[P_UB] + (size_t)st * 8;
    in.fb = (const int*)ptrs[P_FB] + (size_t)st * n.fbl * HW;
    in.pb = (const int*)ptrs[P_PB] + (size_t)st * n.C0 * B * HW;
    in.db = (const int*)ptrs[P_DB] + (size_t)st * B * n.dbl;
    in.aux = ptrs[P_AUX] ? (const float*)ptrs[P_AUX] + (size_t)st * B * 4
                         : nullptr;
    const unsigned long long step = ring ? R->step0 + st + 1 : 0;
    float* g = ring ? ring_slot(R->own, (int)(step & 1), ng) : c.w.grads;
    float* cms = ring ? ring_stats(R->own, (int)(step & 1))
                      : cm + 2 * (size_t)st;
    rc = grad_stages(c, s, in, g, cms);
    if (rc != 0) return rc;
    if (ring) {
      rc = ring_exchange_step(*R, ng, step, c.w.grads, cm + 2 * (size_t)st,
                              s);
      if (rc != 0) return rc;
    }
    rc = update_stages(n, c.prm, mom, c.w.grads, lr, s);
    if (rc != 0) return rc;
  }
  return ring ? ring_finish(*R, s) : 0;
}

// A level's ConvGeom from ``geom`` (B, M, Cin, F, c, e, cs, pad, W), its
// input (B, Cin, W, W) contiguous.
ConvGeom geom_level(const int* geom) {
  const int Cin = geom[2], W = geom[8];
  return {geom[0], geom[1], Cin, geom[3], geom[4], geom[5], geom[6], geom[7],
          W, Cin * W * W, W * W};
}

}  // namespace

extern "C" {

// Floats of scratch the wrapper must allocate for one epoch or step call
// (-1 when the tables are out of range).
long long deep_workspace_floats(const int* is, const float* fs) {
  Net n;
  if (parse(is, fs, &n) != 0) return -1;
  return carve(n, nullptr).total;
}

const char* deep_error_string(int code) {
  if (const char* r = ring_error_string(code)) return r;
  if (code == -1) return "warp field needs more shared memory than a block has";
  if (code == -3) return "more conv levels, hidden layers or state tensors than the kernel's tables hold";
  if (code == -4) return "the net's aux layer has no aux rows (or AuxConcat no encoder weights)";
  if (code == ERR_STAGE_SMEM) return stage_smem_error;
  if (code == ERR_NOT_TILED)
    return "the level's input gradient takes the band path: no tiles";
  return cudaGetErrorString((cudaError_t)code);
}

// The tiled input-gradient launches the library has issued (every entry,
// every thread), for the wrappers' counter.
long long deep_dgrad_tiled_launches() { return dgrad_tiled_launched.load(); }

// The tiled weight-gradient launches the library has issued (every entry,
// every thread), for the wrappers' counter.
long long deep_wgrad_tiled_launches() { return wgrad_tiled_launched.load(); }

// deep_conv_wgrad's scratch at a level for ``tiled``: its partial-sum
// floats, then its counters.
long long deep_conv_wgrad_floats(const int* geom, int tiled) {
  const ConvGeom g = geom_level(geom);
  if (tiled < 0) return wgrad_part_floats(g) + wgrad_counters(g);
  if (tiled == 0) return wgrad_slice_part_floats(g) + wgrad_slice_counters(g);
  const WgradTilePlan t = wgrad_tile_shape(g.B, g.M, g.Cin, g.F, g.e, g.cs);
  return wgrad_tile_part_floats(t) + wgrad_tile_counters(t);
}

// One conv level's weight and bias gradients alone, for the card's checks:
// ``geom`` as deep_conv_dgrad's, ``dz`` (B, M, c, c), ``in`` the level's
// input (B, Cin, W, W), ``dw`` its kernel-layout weights' gradient (M,
// F*F*Cin), ``dbias`` (M,), ``ws`` deep_conv_wgrad_floats floats (the
// counters zeroed here); ``tiled`` 0 k_wgrad, 1 k_wgrad_tiled on
// wgrad_tile_shape (at any level), -1 the path the epoch takes.
int deep_conv_wgrad(const int* geom, int tiled, const float* dz,
                    const float* in, float* dw, float* dbias, float* ws,
                    int device, void* stream_) {
  CHECK(cudaSetDevice(device));
  const ConvGeom g = geom_level(geom);
  const cudaStream_t s = (cudaStream_t)stream_;
  if (tiled < 0) {
    unsigned* ctr = (unsigned*)(ws + wgrad_part_floats(g));
    CHECK(zero_counters(ctr, wgrad_counters(g), s));
    return conv_wgrad(s, g, dz, in, ws, ctr, dw, dbias);
  }
  if (tiled == 0) {
    unsigned* ctr = (unsigned*)(ws + wgrad_slice_part_floats(g));
    CHECK(zero_counters(ctr, wgrad_slice_counters(g), s));
    return launch_wgrad(s, g, dz, in, ws, ctr, dw, dbias);
  }
  const WgradTilePlan t = wgrad_tile_shape(g.B, g.M, g.Cin, g.F, g.e, g.cs);
  unsigned* ctr = (unsigned*)(ws + wgrad_tile_part_floats(t));
  CHECK(zero_counters(ctr, wgrad_tile_counters(t), s));
  return launch_wgrad_tiled(s, g, t, dz, in, ws, ctr, dw, dbias);
}

// One conv level's input gradient alone, for the card's checks: ``geom``
// the level's (B, M, Cin, F, c, e, cs, pad, W), ``w`` its kernel-layout
// weights (M, F*F*Cin), ``dz`` (B, M, c, c), ``din`` (B, Cin, W, W);
// ``tiled`` 0 the band path, 1 the tiled one (an error where the level's
// plan has no tiles), -1 the path the epoch takes.
int deep_conv_dgrad(const int* geom, int tiled, const float* w,
                    const float* dz, float* din, int device, void* stream_) {
  CHECK(cudaSetDevice(device));
  return conv_dgrad((cudaStream_t)stream_, geom_level(geom), w, dz, din,
                    tiled);
}

// One epoch: n_steps steps on ``stream`` of ``device``; parameters and
// momentum in the pointer table are updated in place, cost_minf (n_steps,
// 2) is written. Returns 0, a negative code (deep_error_string), or the
// first CUDA error (the launch that failed never ran).
int deep_epoch(const int* is, const float* fs, void* const* ptrs,
               int n_steps, float lr, float* ws, int device, void* stream_) {
  return epoch_loop(is, fs, ptrs, n_steps, lr, ws, nullptr, device,
                    (cudaStream_t)stream_);
}

// One data-parallel rank's epoch (the port of megastep_ring.py's
// _kernel_ring at the deep family): deep_epoch's pointer table on the
// rank's shard of the data and words, and the ring table of
// ops/megastep_ring.py (csrc/ring.cuh Ring); ``launched`` as in
// megastep_ring_epoch.
int deep_ring_epoch(const int* is, const float* fs, void* const* ptrs,
                    int n_steps, float lr, float* ws, const long long* ring,
                    long long* launched, int device, void* stream_) {
  Ring R;
  int rc = ring_parse(ring, &R);
  if (rc != 0) return rc;
  rc = epoch_loop(is, fs, ptrs, n_steps, lr, ws, &R, device,
                  (cudaStream_t)stream_);
  *launched = R.launched;
  return rc;
}

// One data-parallel step's gradient (the port of megastep_dp.py's
// _kernel_grad at the deep family): grad_stages on one step's inputs,
// pointer table x, y, ub, fb, pb, db, gh, gw, centers, auxw, aux (the
// step's (B, 4) rows), the n_state parameters, the flat gradient buffer and
// cost_minf (2,). Parameters are read only.
int deep_grad_step(const int* is, const float* fs, void* const* ptrs,
                   float* ws, int device, void* stream_) {
  CHECK(cudaSetDevice(device));
  StepCtx c;
  int rc = step_setup(is, fs, ws, (const float*)ptrs[P_GH],
                      (const float*)ptrs[P_GW],
                      (const float*)ptrs[P_CENTERS],
                      (const float*)ptrs[P_AUXW], ptrs + P_STATE, &c);
  if (rc != 0) return rc;
  if (aux_missing(c.n, ptrs)) return -4;
  CHECK(zero_counters(c.w.ctr, c.w.nctr, (cudaStream_t)stream_));
  const int NS = c.n.nstate;
  StepIn in;
  in.x = (const float*)ptrs[P_X];
  in.y = (const int*)ptrs[P_Y];
  in.ub = (const int*)ptrs[P_UB];
  in.fb = (const int*)ptrs[P_FB];
  in.pb = (const int*)ptrs[P_PB];
  in.db = (const int*)ptrs[P_DB];
  in.aux = (const float*)ptrs[P_AUX];
  return grad_stages(c, (cudaStream_t)stream_, in,
                     (float*)ptrs[P_STATE + NS],
                     (float*)ptrs[P_STATE + NS + 1]);
}

// The update after the gradient all-reduce: update_stages with pointer table
// the n_state parameters, the n_state momenta and the flat gradient buffer.
int deep_update(const int* is, const float* fs, void* const* ptrs, float lr,
                int device, void* stream_) {
  Net n;
  int rc = parse(is, fs, &n);
  if (rc != 0) return rc;
  CHECK(cudaSetDevice(device));
  const int NS = n.nstate;
  return update_stages(n, (float* const*)ptrs, (float* const*)ptrs + NS,
                       (const float*)ptrs[2 * NS], lr, (cudaStream_t)stream_);
}

}  // extern "C"

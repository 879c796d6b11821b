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
// What the design does about it (the simplest correct form, first): the
// flagship kernel's design, parameterised at run time. One C call per epoch
// loops the steps on the caller's stream; a level table (input maps, maps,
// filter, input side, conv side, pooled side, pool, ignore_border,
// activation, pad, conv stride, slope) drives one conv+pool stage, one
// pool-backward stage, one weight-gradient stage and one input-gradient
// stage per level (a padded or strided level reads its input directly;
// the input gradient visits only the stride lattice); the
// dense stages loop over the pre-hidden stack and then the final hidden;
// a GEMM computes the scores, one single-block head stage the softmax-kind,
// LOGIT or RBF loss down to dL/dscores (and the RBF centers' gradient when
// they are learned), spread over (sample, output) pairs; the aux encoder is
// one single-block stage forward (k_aux_fwd) and one backward (k_aux_bwd,
// SoftAux only): its widths are a few units; the weight cost is a
// two-pass grid reduction; one update launch covers every state tensor.
// Conv sums are tap by tap in the kernel layout's order with
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

// A conv level: input side s, conv side c, pooled side p; conv output
// (y, x) reads input row y*cs + f-1-u - pad for tap u (zeros off the
// input): pad 0 valid, f/2 'same', f-1 'full'.
struct Level {
  int cin, m, f, s, c, p, pool, ib, act, pad, cs, e;  // e: extent inside
  float slope;                                        // the pool windows
};
struct Pre {
  int w, act;
  float slope, pdrop;
};

struct Net {
  int B, C0, H, HW, nlev, npre, NH, NO, NC, head, acth, learnc, fbl, dbl,
      nstate, NF, loss, nah, nao, auxcat, NT,   // NT: the dense tail's input
      mean;   // a MeanLayer flatten: NF = the last level's maps
  float slopeh, pdrop, junk, boost, logthresh;
  Level lv[MAX_LEVELS];
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
  for (int k = 0; k < n->nlev; ++k, li += N_ILEV, ++lf) {
    Level& L = n->lv[k];
    L.cin = li[L_CIN]; L.m = li[L_M]; L.f = li[L_F]; L.s = li[L_S];
    L.c = li[L_C]; L.p = li[L_P]; L.pool = li[L_POOL]; L.ib = li[L_IB];
    L.act = li[L_ACT]; L.pad = li[L_PAD]; L.cs = li[L_CS];
    L.e = L.ib ? L.p * L.pool : L.c;
    L.slope = lf[0];
  }
  for (int j = 0; j < n->npre; ++j, li += N_IPRE, lf += 2) {
    n->pre[j].w = li[H_W]; n->pre[j].act = li[H_ACT];
    n->pre[j].slope = lf[0]; n->pre[j].pdrop = lf[1];
  }
  n->ten = li;
  n->reg = lf;
  if (n->nlev) {
    const Level& L = n->lv[n->nlev - 1];
    n->NF = n->mean ? L.m : L.m * L.p * L.p;
  } else {
    n->NF = n->C0 * n->HW;
  }
  n->NT = n->NF + (n->auxcat ? n->nao : 0);
  return 0;
}

struct AugParams {
  int warp, nearest, invert, color;
  float pflip, maxval, inv_maxval, logbal, loggam;
};

// x ** g for x in [0, 1] as exp(g log x), x == 0 giving 0 exactly.
__device__ __forceinline__ float pow01(float x, float g) {
  return x > 0.0f ? expf(__fmul_rn(g, logf(fmaxf(x, 1e-30f)))) : 0.0f;
}

// [Color ->] invert -> resample at the shared warp -> pflip. One thread per
// output pixel, written sample-major (b, c, p) = the conv input layout and
// the flat nets' flatten order; the input rows and the pflip and color
// words are channel-major (r = c*B + b). Products and sums are rounded one
// by one, as in the twin.
__global__ void k_augment(int B, int C0, int H, AugParams g,
                          const float* __restrict__ x,
                          const float* __restrict__ tyx,
                          const int* __restrict__ fb,
                          const int* __restrict__ pb, float* __restrict__ a) {
  const int HW = H * H;
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * C0 * HW) return;
  const int p = idx % HW, c = (idx / HW) % C0, b = idx / (HW * C0);
  const int r = c * B + b;
  const float* row = x + (size_t)r * HW;
  float f0 = 1.0f, f1 = 1.0f, f2 = 1.0f;
  if (g.color) {   // per-row factors from field-word rows 4-6, column r
    f0 = expf(__fmul_rn(g.logbal, 2.0f * u01(fb[4 * HW + r]) - 1.0f));
    f1 = expf(__fmul_rn(g.loggam, 2.0f * u01(fb[5 * HW + r]) - 1.0f));
    f2 = expf(__fmul_rn(g.loggam, 2.0f * u01(fb[6 * HW + r]) - 1.0f));
  }
  auto tap = [&](int q) {
    float v = row[q];
    if (g.color) {
      float xm = __fmul_rn(v, g.inv_maxval);
      xm = fminf(fmaxf(__fmul_rn(xm, f0), 0.0f), 1.0f);
      xm = pow01(xm, f1);
      xm = 1.0f - pow01(1.0f - xm, f2);
      v = __fmul_rn(xm, g.maxval);
    }
    return g.invert ? 1.0f - v : v;
  };
  float v;
  if (!g.warp) {
    v = tap(p);
  } else if (g.nearest) {
    int vy = (int)floorf(tyx[p] + 0.5f);
    int vx = (int)floorf(tyx[HW + p] + 0.5f);
    v = tap(vy * H + vx);
  } else {
    float ty = tyx[p], tx = tyx[HW + p];
    int top = (int)ty, left = (int)tx;
    float fy = ty - (float)top, fx = tx - (float)left;
    int i00 = top * H + left;
    float gy = 1.0f - fy, gx = 1.0f - fx;
    v = __fadd_rn(__fadd_rn(__fadd_rn(
            __fmul_rn(tap(i00), __fmul_rn(gy, gx)),
            __fmul_rn(tap(i00 + 1), __fmul_rn(gy, fx))),
            __fmul_rn(tap(i00 + H), __fmul_rn(fy, gx))),
            __fmul_rn(tap(i00 + H + 1), __fmul_rn(fy, fx)));
  }
  if (g.pflip > 0.0f && u01(pb[(size_t)r * HW + p]) < g.pflip) v = 1.0f - v;
  a[idx] = v;
}

// One conv level (true convolution at the level's pad and stride) + bias
// + act + max-pool: one thread per pooled output; writes the
// pre-activations z of its window and the pooled max. ``in`` (B, Cin, S,
// S) is addressed as b*sb + c*sc + y*S + x. Taps are summed in the twin's
// order with separately rounded multiplies and adds (no FMA): the pool's
// gradient goes to every exact tie, and which outputs tie depends on the
// order of the sum. A tap off the input adds nothing, which is what the
// twin's zero product adds.
__global__ void k_conv_pool(int B, Level L, const float* __restrict__ in,
                            int sb, int sc, const float* __restrict__ w,
                            const float* __restrict__ bias,
                            float* __restrict__ z, float* __restrict__ pout) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * L.m * L.p * L.p) return;
  const int F = L.f, Cin = L.cin, S = L.s, c = L.c;
  int j = idx % L.p, i = (idx / L.p) % L.p;
  int m = (idx / (L.p * L.p)) % L.m, b = idx / (L.p * L.p * L.m);
  const float* wm = w + m * F * F * Cin;
  const float* ib = in + (size_t)b * sb;
  float best = -INFINITY;
  for (int dy = 0; dy < L.pool; ++dy) {
    int y = i * L.pool + dy;
    if (y >= c) break;
    for (int dx = 0; dx < L.pool; ++dx) {
      int xx = j * L.pool + dx;
      if (xx >= c) break;
      float acc = 0.0f;
      for (int u = 0; u < F; ++u) {
        const int iy = y * L.cs + F - 1 - u - L.pad;
        if (iy < 0 || iy >= S) continue;
        for (int v = 0; v < F; ++v) {
          const int ix = xx * L.cs + F - 1 - v - L.pad;
          if (ix < 0 || ix >= S) continue;
          for (int ci = 0; ci < Cin; ++ci)
            acc = __fadd_rn(acc, __fmul_rn(wm[(u * F + v) * Cin + ci],
                                           ib[ci * sc + iy * S + ix]));
        }
      }
      float zz = acc + bias[m];
      z[((b * L.m + m) * c + y) * c + xx] = zz;
      best = fmaxf(best, act_fn(zz, L.act, L.slope));
    }
  }
  pout[idx] = best;
}

// Pool backward + act': one thread per conv output position; the window's
// gradient reaches every element equal to its max, positions outside the
// windows (ignore_border) get none.
__global__ void k_pool_bwd(int B, Level L, const float* __restrict__ z,
                           const float* __restrict__ pout,
                           const float* __restrict__ dp,
                           float* __restrict__ dz) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * L.m * L.c * L.c) return;
  int x = idx % L.c, y = (idx / L.c) % L.c;
  int m = (idx / (L.c * L.c)) % L.m, b = idx / (L.c * L.c * L.m);
  float g = 0.0f;
  if (y < L.e && x < L.e) {
    float zz = z[idx];
    int o = ((b * L.m + m) * L.p + y / L.pool) * L.p + x / L.pool;
    if (act_fn(zz, L.act, L.slope) == pout[o])
      g = dp[o] * dact_fn(zz, L.act, L.slope);
  }
  dz[idx] = g;
}

// The first tap u >= 0 whose output row y = (r + u) / cs is a whole
// number >= 0, for r = i + pad - (F-1) of input row i; the next ones are
// u + cs, u + 2 cs, ... at y + 1, y + 2, ...
__device__ __forceinline__ int first_tap(int r, int cs) {
  return r < 0 ? -r : (cs - r % cs) % cs;
}

// Input gradient of a conv level: one thread per input position (b, c, i,
// j) of the level's (B, Cin, S, S) input, which is the previous level's
// pooled output. It visits only the outputs on the stride lattice whose
// taps read it, inside the pool windows' extent, in the order m, u, v (at
// stride 1 and pad 0 the valid conv's sum, term for term).
__global__ void k_conv_dgrad(int B, Level L, const float* __restrict__ w,
                             const float* __restrict__ dz,
                             float* __restrict__ din) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int S = L.s, F = L.f, Cin = L.cin, cs = L.cs;
  if (idx >= B * Cin * S * S) return;
  int j = idx % S, i = (idx / S) % S;
  int ci = (idx / (S * S)) % Cin, b = idx / (S * S * Cin);
  const int ri = i + L.pad - (F - 1), rj = j + L.pad - (F - 1);
  const int u0 = first_tap(ri, cs), v0 = first_tap(rj, cs);
  const int y0 = (ri + u0) / cs, x0 = (rj + v0) / cs;
  float s = 0.0f;
  for (int m = 0; m < L.m; ++m)
    for (int u = u0, y = y0; u < F && y < L.e; u += cs, ++y)
      for (int v = v0, x = x0; v < F && x < L.e; v += cs, ++x)
        s += w[m * F * F * Cin + (u * F + v) * Cin + ci]
             * dz[((b * L.m + m) * L.c + y) * L.c + x];
  din[idx] = s;
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

// A pre-hidden layer's act + dropout: hd = act(z) * mask.
__global__ void k_act_drop(int B, int W, int act, float slope, float pdrop,
                           const int* __restrict__ db, int dbl, int off,
                           const float* __restrict__ z,
                           float* __restrict__ hd) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B * W) return;
  float h = act_fn(z[e], act, slope);
  hd[e] = kept(db, dbl, off, e / W, e % W, pdrop) ? h : 0.0f * h;
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
// b2, w1, b1, and cb's, which is bt's (``gbt``, written by k_head).
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

// A softmax-kind head's loss on one sample's scores zb (NO of them, y the
// label, ok whether it lies in [0, NO)): writes dL/dscores to gb and
// returns the sample's term of the loss sum; *mfb gets the watchdog value,
// the true-class log-probability or, for hinge and exp, the true-class
// score (megastep.py:1513-1563, 1660-1686).
__device__ float softmax_kind_loss(const HeadArgs& h, const float* zb,
                                   int yb, bool ok, float* gb, float* mfb) {
  const int NO = h.NO;
  const float invB = 1.0f / (float)h.B;
  if (h.loss == LOSS_HINGE) {   // the mean over the whole (B, NC) matrix
    const float ts = ok ? zb[yb] : NAN, inv = 1.0f / (float)(h.B * NO);
    float lsum = 0.0f, msum = 0.0f;
    for (int c = 0; c < NO; ++c) {
      float marg = zb[c] + 1.0f - ts;
      lsum += fmaxf(marg, 0.0f);
      msum += marg > 0.0f ? 1.0f : 0.0f;
    }
    for (int c = 0; c < NO; ++c) {
      float m = zb[c] + 1.0f - ts > 0.0f ? 1.0f : 0.0f;
      gb[c] = (m - (c == yb ? msum : 0.0f)) * inv;
    }
    *mfb = ts;
    return lsum;
  }
  if (h.loss == LOSS_EXP) {     // on the row-centred scores
    float mean = 0.0f;
    for (int c = 0; c < NO; ++c) mean += zb[c];
    mean /= (float)NO;
    const float ts = ok ? zb[yb] - mean : NAN, e = expf(-ts);
    for (int c = 0; c < NO; ++c)
      gb[c] = (e * invB) * (1.0f / (float)NO - (c == yb ? 1.0f : 0.0f));
    *mfb = ts;
    return e;
  }
  float mx = -INFINITY;
  for (int c = 0; c < NO; ++c) mx = fmaxf(mx, zb[c]);
  float se = 0.0f;
  for (int c = 0; c < NO; ++c) se += expf(zb[c] - mx);
  const float lse = logf(se);
  const float t = ok ? (zb[yb] - mx) - lse : NAN;
  const float gate = h.logthresh - t > 0.0f ? 1.0f : 0.0f;
  for (int c = 0; c < NO; ++c) {
    const float p = expf((zb[c] - mx) - lse), oh = c == yb ? 1.0f : 0.0f;
    gb[c] = h.loss == LOSS_NLLSQ ? (2.0f * t * invB) * (oh - p)
            : h.loss == LOSS_NLLT ? (gate * invB) * (p - oh)
                                  : (p - oh) * invB;
  }
  *mfb = t;
  return h.loss == LOSS_NLLSQ ? t * t
         : h.loss == LOSS_NLLT ? fmaxf(0.0f, h.logthresh - t) : -t;
}

// The head's loss and what needs a batch-wide view, in one block: from the
// scores z4 = h3d wo + bo (a grid GEMM before it; for SoftAux f Wt + bt +
// cb + h2a cw), (cost, minf), dL/dz4, the scores bias's gradient and
// (learned RBF centers) dcenters. The work is spread over (sample, output)
// pairs; only each sample's normalisation loops over its own classes. The
// dense backward below the scores runs in the grid stages after it. Its
// scratch (head_floats) is dynamic shared memory (WS false) or, for a head
// beyond the shared memory a block can opt in to, the workspace region
// ``ws`` (WS true); the operations and their order are the same.
template <bool WS>
__global__ void __launch_bounds__(1024)
k_head(HeadArgs h, float* __restrict__ ws, const float* __restrict__ z4g,
       const float* __restrict__ cen, const int* __restrict__ y,
       const float* __restrict__ wcost, float* __restrict__ dz4,
       float* __restrict__ gbo, float* __restrict__ gcen,
       float* __restrict__ cm) {
  extern __shared__ float smem[];
  float* sm = WS ? ws : smem;
  const int B = h.B, NO = h.NO, NC = h.NC;
  float* z4 = sm;               // B*NO scores (features' pre-activations)
  float* v = z4 + B * NO;       // B*NO RBF features 1.7 tanh(2/3 z4)
  float* dd = v + B * NO;       // B*NC RBF: -dists, then dL/d dists
  float* csq = dd + B * NC;     // NC RBF ||c||^2
  float* ssv = csq + NC;        // B RBF ||v||^2
  float* rs = ssv + B;          // B RBF sum over classes of dL/d dists
  float* tl = rs + B;           // B per-sample loss terms
  float* mf = tl + B;           // B watchdog features
  const int tid = threadIdx.x, nt = blockDim.x;
  const float invB = 1.0f / (float)B;
  const bool rbf = h.kind == HEAD_RBF;

  for (int e = tid; e < B * NO; e += nt) z4[e] = z4g[e];
  if (rbf)
    for (int c = tid; c < NC; c += nt) {
      float s = 0.0f;
      for (int f = 0; f < NO; ++f) s += cen[c * NO + f] * cen[c * NO + f];
      csq[c] = s;
    }
  __syncthreads();
  if (rbf) {
    for (int e = tid; e < B * NO; e += nt)
      v[e] = 1.7f * tanhf(z4[e] * (2.0f / 3.0f));
    __syncthreads();
    for (int b = tid; b < B; b += nt) {
      float s = 0.0f;
      for (int f = 0; f < NO; ++f) s += v[b * NO + f] * v[b * NO + f];
      ssv[b] = s;
    }
    __syncthreads();
    for (int e = tid; e < B * NC; e += nt) {  // -dists, by the expansion
      int b = e / NC, c = e % NC;
      float dot = 0.0f;
      for (int f = 0; f < NO; ++f) dot += v[b * NO + f] * cen[c * NO + f];
      dd[e] = -((ssv[b] - 2.0f * dot) + csq[c]);
    }
    __syncthreads();
  }
  for (int b = tid; b < B; b += nt) {
    const int yb = y[b];
    const bool ok = yb >= 0 && yb < NC;
    const int yc = max(0, min(yb, NO - 1));   // the watchdog's feature
    const float* zb = z4 + b * NO;
    float* gb = dz4 + b * NO;
    float t = NAN;  // a label outside [0, NC) poisons the cost
    if (h.kind == HEAD_SOFTMAX || h.kind == HEAD_SOFTAUX) {
      tl[b] = softmax_kind_loss(h, zb, yb, ok, gb, mf + b);
      continue;
    } else if (h.kind == HEAD_LOGIT) {
      // features squeezed into [eps, 1-eps]; bit probabilities against the
      // true class's center row
      float s = 0.0f;
      for (int f = 0; f < NO; ++f) {
        float sg = 1.0f / (1.0f + expf(-zb[f]));
        float vf = sg * (1.0f - 2.0f * LOGIT_EPS) + LOGIT_EPS;
        float c = ok ? cen[yb * NO + f] : NAN;
        float bp = c * vf + (1.0f - c) * (1.0f - vf);
        s += logf(bp);
        gb[f] = (1.0f - 2.0f * c) / ((float)B * bp)
                * (1.0f - 2.0f * LOGIT_EPS) * sg * (1.0f - sg);
      }
      if (ok) t = s;
      mf[b] = 1.0f / (1.0f + expf(-zb[yc]));
    } else {   // the junk column joins the partition sum only
      float* db_ = dd + b * NC;
      float mx = -h.junk;
      for (int c = 0; c < NC; ++c) mx = fmaxf(mx, db_[c]);
      float se = 0.0f;
      for (int c = 0; c < NC; ++c) se += expf(db_[c] - mx);
      float lse = logf(se + expf(-h.junk - mx));
      float r = 0.0f;
      for (int c = 0; c < NC; ++c) {
        float lp = db_[c] - mx - lse;
        if (c == yb) t = lp;
        db_[c] = -((expf(lp) - (c == yb ? 1.0f : 0.0f)) * invB);
        r += db_[c];
      }
      rs[b] = r;
      mf[b] = v[b * NO + yc];
    }
    tl[b] = -t;
  }
  __syncthreads();
  if (rbf)
    for (int e = tid; e < B * NO; e += nt) {  // through the features
      int b = e / NO, f = e % NO;
      float s = 0.0f;
      for (int c = 0; c < NC; ++c) s += dd[b * NC + c] * cen[c * NO + f];
      float tf = tanhf(z4[e] * (2.0f / 3.0f));
      float dv = 2.0f * (v[e] * rs[b] - s);
      dz4[e] = dv * 1.7f * (2.0f / 3.0f) * (1.0f - tf * tf);
    }
  if (tid == 0) {
    float s = 0.0f, mn = INFINITY;
    for (int b = 0; b < B; ++b) {
      s += tl[b];
      mn = fminf(mn, mf[b]);
    }
    const bool hinge = (h.kind == HEAD_SOFTMAX || h.kind == HEAD_SOFTAUX)
                       && h.loss == LOSS_HINGE;
    cm[0] = s / (float)(hinge ? B * NC : B) + (wcost ? wcost[0] : 0.0f);
    cm[1] = mn;
  }
  __syncthreads();   // dz4 is read back below
  for (int c = tid; c < NO; c += nt) {
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += dz4[b * NO + c];
    gbo[c] = s;
  }
  if (rbf && gcen)
    for (int e = tid; e < NC * NO; e += nt) {
      int c = e / NO, f = e % NO;
      float cs = 0.0f, s = 0.0f;
      for (int b = 0; b < B; ++b) {
        float g = dd[b * NC + c];
        cs += g;
        s += g * v[b * NO + f];
      }
      gcen[e] = 2.0f * (cen[e] * cs - s);
    }
}

// Floats of k_head's scratch.
long long head_floats(const Net& n) {
  return 2LL * n.B * n.NO + (long long)n.B * n.NC + n.NC + 4LL * n.B;
}

struct Workspace {
  float *tyx, *a, *grads, *wcost, *wpart;
  float *z[MAX_LEVELS], *p[MAX_LEVELS], *dz[MAX_LEVELS], *dp[MAX_LEVELS];
  float *pz[MAX_PRE], *phd[MAX_PRE], *pdh[MAX_PRE], *pdz[MAX_PRE];
  float *z3, *h3d, *z4, *dz4, *dh3, *dz3;
  float *x2, *z1a, *h1a, *z2a, *h2a, *dz1a, *dz2a, *fcat;   // aux encoder
  float *fmean, *dmean;   // the MeanLayer flatten and its gradient
  float* df;   // where the tail's input gradient lands: the flatten's
  float* head;   // k_head's scratch when it is beyond the opt-in
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
    const Level& L = n.lv[k];
    w.z[k] = take(B * L.m * L.c * L.c);
    w.dz[k] = take(B * L.m * L.c * L.c);
    w.p[k] = take(B * L.m * L.p * L.p);
    w.dp[k] = take(B * L.m * L.p * L.p);
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
  w.head = take(head_floats(n));
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
  size_t warp_smem, hsm;
  bool head_ws;   // k_head's scratch in the workspace (beyond the opt-in)
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
  c->hsm = sizeof(float) * (size_t)head_floats(n);
  c->head_ws = c->hsm > SMEM_OPT_IN;
  if (!c->head_ws && !smem_opt_in(k_head<false>, c->hsm)) return -2;
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

// k_head on the step's scores w.z4: its scratch in shared memory, or in
// the workspace beyond the opt-in (step_setup).
cudaError_t launch_head(const StepCtx& c, cudaStream_t s, const float* cen,
                        const int* y, float* gbo, float* gcen, float* cm) {
  const Workspace& w = c.w;
  const float* wc = c.any_wcost ? w.wcost : nullptr;
  if (c.head_ws)
    k_head<true><<<1, 1024, 0, s>>>(c.ha, w.head, w.z4, cen, y, wc, w.dz4,
                                    gbo, gcen, cm);
  else
    k_head<false><<<1, 1024, c.hsm, s>>>(c.ha, nullptr, w.z4, cen, y, wc,
                                         w.dz4, gbo, gcen, cm);
  return cudaGetLastError();
}

// SoftAux head on the flatten f (B, NF), forward and backward: the scores
// f Wt + bt, the aux logits (k_aux_fwd), the loss (k_head), the encoder's
// and cross weights' gradients (k_aux_bwd), dWt and df into w.df (the
// last level's pooled gradient, or the MeanLayer flatten's).
int softaux_stages(const StepCtx& c, cudaStream_t s, const StepIn& in,
                   const float* f, float* const* grad, float* cm) {
  const Net& n = c.n;
  const Workspace& w = c.w;
  float* const* prm = c.prm;
  const int th = c.th, B = n.B, NC = n.NO, NF = n.NF;
  CHECK((gemm<false, false>(s, B, NC, NF, f, NF, prm[th], NC, prm[th + 1],
                            w.z4)));
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
  CHECK((gemm<true, false>(s, NF, NC, B, f, NF, w.dz4, NC, nullptr,
                           grad[th])));
  return (int)gemm<false, true>(s, B, NF, NC, w.dz4, NC, prm[th], NC,
                                nullptr, w.df);
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
                              prm[t + 1], w.pz[j])));
    k_act_drop<<<blocks((long long)B * P.w, T), T, 0, s>>>(
        B, P.w, P.act, P.slope, P.pdrop, in.db, n.dbl, off, w.pz[j],
        w.phd[j]);
    LAUNCHED();
    f = w.phd[j];
    fw = P.w;
    off += P.w;
  }
  CHECK((gemm<false, false>(s, B, n.NH, fw, f, fw, prm[th], n.NH,
                            prm[th + 1], w.z3)));
  k_act_drop<<<blocks((long long)B * n.NH, T), T, 0, s>>>(
      B, n.NH, n.acth, n.slopeh, n.pdrop, in.db, n.dbl, dboff, w.z3, w.h3d);
  LAUNCHED();
  CHECK((gemm<false, false>(s, B, n.NO, n.NH, w.h3d, n.NH, prm[th + 2],
                            n.NO, prm[th + 3], w.z4)));
  if (c.any_wcost) CHECK(wcost(s, c.wt, w.wpart, w.wcost));
  CHECK(launch_head(c, s, c.cen, in.y, grad[th + 3],
                    n.learnc ? grad[th + 4] : nullptr, cm));
  // dwo = h3d^T dz4; dz3 = (dz4 wo^T) * mask * act'(z3), dbh
  CHECK((gemm<true, false>(s, n.NH, n.NO, B, w.h3d, n.NH, w.dz4, n.NO,
                           nullptr, grad[th + 2])));
  CHECK((gemm<false, true>(s, B, n.NH, n.NO, w.dz4, n.NO, prm[th + 2],
                           n.NO, nullptr, w.dh3)));
  k_dense_bwd<<<blocks(n.NH, T), T, 0, s>>>(
      B, n.NH, n.acth, n.slopeh, n.pdrop, in.db, n.dbl, dboff, w.z3, w.dh3,
      w.dz3, grad[th + 1]);
  LAUNCHED();
  // backward through the dense tail: dwh = f^T dz3; df = dz3 wh^T lands
  // in the gradient buffer of f (the last pre-hidden's output or w.df,
  // the flatten's NF columns)
  CHECK((gemm<true, false>(s, fw, n.NH, B, f, fw, w.dz3, n.NH, nullptr,
                           grad[th])));
  if (need_df) {
    float* dst = n.npre ? w.pdh[n.npre - 1] : w.df;
    CHECK((gemm<false, true>(s, B, n.npre ? fw : n.NF, n.NH, w.dz3, n.NH,
                             prm[th], n.NH, nullptr, dst)));
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
                             nullptr, grad[t])));
    if (j || n.nlev) {
      float* dst = j ? w.pdh[j - 1] : w.df;
      CHECK((gemm<false, true>(s, B, j ? inw : n.NF, P.w, w.pdz[j], P.w,
                               prm[t], P.w, nullptr, dst)));
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
  // forward: conv levels (input (B, Cin, S, S) at strides sb, sc)
  const float* inp = w.a;
  int sb = n.C0 * HW, sc = HW;
  for (int k = 0; k < n.nlev; ++k) {
    const Level& L = n.lv[k];
    k_conv_pool<<<blocks((long long)B * L.m * L.p * L.p, T), T, 0, s>>>(
        B, L, inp, sb, sc, prm[2 * k], prm[2 * k + 1], w.z[k], w.p[k]);
    LAUNCHED();
    inp = w.p[k];
    sb = L.m * L.p * L.p;
    sc = L.p * L.p;
  }
  const Level* last = n.nlev ? &n.lv[n.nlev - 1] : nullptr;
  if (n.mean) {
    k_mean_fwd<<<blocks((long long)B * last->m, T), T, 0, s>>>(
        B * last->m, last->p * last->p, inp, w.fmean);
    LAUNCHED();
    inp = w.fmean;
  }
  // the head, the dense tail and their backward down to the flatten
  int rc = n.head == HEAD_SOFTAUX ? softaux_stages(c, s, in, inp, grad, cm)
                                  : dense_stages(c, s, in, inp, grad, cm);
  if (rc != 0) return rc;
  if (n.mean) {
    k_mean_bwd<<<blocks((long long)B * last->m * last->p * last->p, T), T, 0,
                 s>>>(B * last->m, last->p * last->p, w.dmean,
                      w.dp[n.nlev - 1]);
    LAUNCHED();
  }
  // backward through the conv levels
  for (int k = n.nlev - 1; k >= 0; --k) {
    const Level& L = n.lv[k];
    k_pool_bwd<<<blocks((long long)B * L.m * L.c * L.c, T), T, 0, s>>>(
        B, L, w.z[k], w.p[k], w.dp[k], w.dz[k]);
    LAUNCHED();
    const float* lin = k ? w.p[k - 1] : w.a;
    const int lsb = k ? L.cin * L.s * L.s : n.C0 * HW;
    k_conv_wgrad<<<dim3(L.m, L.f * L.f * L.cin + 1), T, 0, s>>>(
        B, L.m, L.cin, L.f, L.c, L.e, w.dz[k], lin, lsb, L.s * L.s, L.s,
        grad[2 * k], grad[2 * k + 1], L.cs, L.pad);
    LAUNCHED();
    if (k) {
      k_conv_dgrad<<<blocks((long long)B * L.cin * L.s * L.s, T), T, 0, s>>>(
          B, L, prm[2 * k], w.dz[k], w.dp[k - 1]);
      LAUNCHED();
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
  if (code == -2) return "the head kernel's shared-memory opt-in failed";
  if (code == -3) return "more conv levels, hidden layers or state tensors than the kernel's tables hold";
  if (code == -4) return "the net's aux layer has no aux rows (or AuxConcat no encoder weights)";
  return cudaGetErrorString((cudaError_t)code);
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

// Whole-epoch fused training of the 2-conv flagship net, for Hopper (sm_90a).
//
// Replaces theanet_tpu/ops/megastep.py::_kernel (the Pallas epoch kernel,
// built by make_epoch_fn / build_epoch_fn) and, at the flagship,
// theanet_tpu/ops/megastep_dp.py::_kernel_grad. Its plain PyTorch twin, which
// is the specification this file is held to, is
// theanet_tpu_torch/ops/megastep.py::megastep_epoch_reference.
//
// What it computes, per step of the epoch: elastic augmentation from the
// injected bits (invert, translate, Box-Muller field smoothed by the
// separable Gaussian G_h F G_w^T, zoom and rotation about a random origin,
// clip, nearest or bilinear resample, pflip); conv1 -> act -> max-pool ->
// conv2 -> act -> max-pool -> flatten -> hidden -> act -> dropout mask ->
// scores -> log-softmax -> mean NLL (+ L1/L2 weight cost); the hand-derived
// backward (pool gradients reach every tied maximum, activation derivatives
// recomputed from the pre-activation); then L1/L2 gradients, the
// old-accumulator momentum step and max-norm, in place.
//
// What bounds it on the card. At the flagship shapes (batch 20, 28x28,
// maps 4/20, hidden 500) a step is ~25 M multiply-adds, ~60% of them in the
// three 20x720x500 hidden products, and it depends on the previous step's
// parameters. The step is far too small to fill 132 SMs, so the epoch is
// bound by latency: the number of dependent stages per step and the time
// each takes to launch and drain, not by FLOPs or bytes. Parameter and
// momentum state (2 x 1.47 MB) does not fit one SM's shared memory and
// lives in device memory, where it stays resident in the 50 MB L2.
//
// What the design does about it: one C call per epoch loops the steps on
// the caller's stream and launches a few small stage kernels per step (fewer
// when the config has no warp, weight cost or max-norm), each sized to the
// card rather than to the data: the forward convs a thread per pooled
// output (their sum order decides which pool windows tie); the dense
// products on 16x16 tiles that cut K into slices when the tiles alone are
// too few to fill 132 SMs, with the bias, activation and dropout in the
// pass that writes the result (stages.cuh gemm); the conv weight gradients
// over fixed batch slices, a block a slice staging its rows once for every
// map and tap, the slices added in order by clusters (conv_wgrad); the conv2
// input gradient a block a (row band, map, sample) on a zero-padded copy
// of the sample's dz, with pool1's backward in its epilogue; the softmax
// head and its backward as grid stages around a loss of one block a sample
// (k_head_*). Every cross-block sum runs in one order fixed by the shapes;
// nothing is added atomically and nothing is computed by a library kernel.
// Fewer stages (persistent kernels, CUDA graphs, wgmma) are later work;
// PERF.md has the measured times.
//
// Data-parallel training (the port of theanet_tpu/ops/megastep_dp.py's
// _kernel_grad at the flagship) splits a step in two entries that run the
// epoch's own helpers: megastep_grad_step runs grad_stages (k_warp through
// the last conv_wgrad) at the per-rank batch into a caller-owned flat
// gradient buffer, and megastep_update runs update_stages (k_update and the
// max-norm kernels) on that buffer after the caller's all-reduce. The epoch
// loop calls the same two helpers, so the two paths cannot drift apart.
//
// The whole-epoch data-parallel entry (the port of
// theanet_tpu/ops/megastep_ring.py::_kernel_ring at the flagship),
// megastep_ring_epoch, is the same epoch loop with one more stage a step:
// grad_stages writes the rank's gradient into its slot of a peer-mapped
// exchange buffer, the exchange of csrc/ring.cuh reduces the ranks' slots,
// and update_stages applies the reduced gradient. One C call an epoch a
// rank; at one rank it is megastep_epoch.

#include "stages.cuh"
#include "ring.cuh"

namespace {

// ---- integer spec (order fixed by theanet_tpu_torch/ops/_build.py)
enum {
  I_B, I_C0, I_H, I_F1, I_F2, I_M1, I_M2, I_NH, I_NC, I_POOL1, I_POOL2,
  I_IB1, I_IB2, I_ACT1, I_ACT2, I_ACTH, I_INVERT, I_NEAREST, I_TRANS, I_MAG,
  I_ZOOM, I_ANGLE, I_PFLIP, I_PDROP, N_ISPEC
};
// ---- float spec; then per layer (conv1, conv2, hidden, out) 7 values
enum {
  F_SLOPE1, F_SLOPE2, F_SLOPEH, F_PDROP, F_TRANS, F_LOGZOOM, F_MAG, F_PFLIP,
  F_ANGLE, F_CLIPHI, F_REG0
};
// ---- pointer table
enum {
  P_X, P_Y, P_UB, P_FB, P_PB, P_DB, P_GH, P_GW, P_PARAMS,
  P_MOMS = P_PARAMS + 8, P_CM = P_MOMS + 8, N_PTRS
};

struct Dims {
  int B, C0, H, HW, F1, F2, M1, M2, NH, NC, pool1, pool2;
  int c1, P1, e1, c2, P2, e2, NF;  // e: extent of positions inside windows
  int act1, act2, acth;
  float slope1, slope2, slopeh, pdrop;
};

Dims make_dims(const int* is, const float* fs) {
  Dims d;
  d.B = is[I_B]; d.C0 = is[I_C0]; d.H = is[I_H]; d.HW = d.H * d.H;
  d.F1 = is[I_F1]; d.F2 = is[I_F2]; d.M1 = is[I_M1]; d.M2 = is[I_M2];
  d.NH = is[I_NH]; d.NC = is[I_NC];
  d.pool1 = is[I_POOL1]; d.pool2 = is[I_POOL2];
  d.c1 = d.H - d.F1 + 1;
  d.P1 = is[I_IB1] ? d.c1 / d.pool1 : (d.c1 + d.pool1 - 1) / d.pool1;
  d.e1 = is[I_IB1] ? d.P1 * d.pool1 : d.c1;
  d.c2 = d.P1 - d.F2 + 1;
  d.P2 = is[I_IB2] ? d.c2 / d.pool2 : (d.c2 + d.pool2 - 1) / d.pool2;
  d.e2 = is[I_IB2] ? d.P2 * d.pool2 : d.c2;
  d.NF = d.M2 * d.P2 * d.P2;
  d.act1 = is[I_ACT1]; d.act2 = is[I_ACT2]; d.acth = is[I_ACTH];
  d.slope1 = fs[F_SLOPE1]; d.slope2 = fs[F_SLOPE2]; d.slopeh = fs[F_SLOPEH];
  d.pdrop = fs[F_PDROP];
  return d;
}

// Invert -> resample at the shared warp -> pflip, one thread per pixel of
// every channel-major row (c*B + b).
__global__ void k_augment(Dims d, int warp, int nearest, int invert,
                          float pflip, const float* __restrict__ x,
                          const float* __restrict__ tyx,
                          const int* __restrict__ pb, float* __restrict__ a) {
  const int HW = d.HW, H = d.H;
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= d.C0 * d.B * HW) return;
  const float* row = x + (idx / HW) * HW;
  int p = idx % HW;
  float v;
  if (!warp) {
    v = row[p];
    if (invert) v = 1.0f - v;
  } else if (nearest) {
    int vy = (int)floorf(tyx[p] + 0.5f);
    int vx = (int)floorf(tyx[HW + p] + 0.5f);
    v = row[vy * H + vx];
    if (invert) v = 1.0f - v;
  } else {
    float ty = tyx[p], tx = tyx[HW + p];
    int top = (int)ty, left = (int)tx;
    float fy = ty - (float)top, fx = tx - (float)left;
    int i00 = top * H + left;
    float x00 = row[i00], x01 = row[i00 + 1];
    float x10 = row[i00 + H], x11 = row[i00 + H + 1];
    if (invert) {
      x00 = 1.0f - x00; x01 = 1.0f - x01;
      x10 = 1.0f - x10; x11 = 1.0f - x11;
    }
    v = x00 * ((1.0f - fy) * (1.0f - fx)) + x01 * ((1.0f - fy) * fx)
        + x10 * (fy * (1.0f - fx)) + x11 * (fy * fx);
  }
  if (pflip > 0.0f && u01(pb[idx]) < pflip) v = 1.0f - v;
  a[idx] = v;
}

// conv1 (true convolution, valid) + act + max-pool, one thread per pooled
// output; writes the pre-activations z1 of its window and the pooled max.
// The conv sums taps in the twin's order with separately rounded multiplies
// and adds (no FMA): the pool's gradient goes to every exact tie, and which
// outputs tie depends on the order of the sum.
__global__ void k_conv1_pool(Dims d, const float* __restrict__ a,
                             const float* __restrict__ w1,
                             const float* __restrict__ b1,
                             float* __restrict__ z1, float* __restrict__ p1) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= d.B * d.M1 * d.P1 * d.P1) return;
  const int F = d.F1, C0 = d.C0, H = d.H;
  int j = idx % d.P1, i = (idx / d.P1) % d.P1;
  int m = (idx / (d.P1 * d.P1)) % d.M1, b = idx / (d.P1 * d.P1 * d.M1);
  const float* wm = w1 + m * F * F * C0;
  float best = -INFINITY;
  for (int dy = 0; dy < d.pool1; ++dy) {
    int y = i * d.pool1 + dy;
    if (y >= d.c1) break;
    for (int dx = 0; dx < d.pool1; ++dx) {
      int xx = j * d.pool1 + dx;
      if (xx >= d.c1) break;
      float acc = 0.0f;   // tap order and rounding shared with the twin
      for (int u = 0; u < F; ++u)
        for (int v = 0; v < F; ++v)
          for (int c = 0; c < C0; ++c)
            acc = __fadd_rn(acc, __fmul_rn(
                wm[(u * F + v) * C0 + c],
                a[(c * d.B + b) * d.HW + (y + F - 1 - u) * H
                  + (xx + F - 1 - v)]));
      float z = acc + b1[m];
      z1[((b * d.M1 + m) * d.c1 + y) * d.c1 + xx] = z;
      best = fmaxf(best, act_fn(z, d.act1, d.slope1));
    }
  }
  p1[idx] = best;
}

// conv2 + act + max-pool, one thread per pooled output; the pooled value
// lands in the flattened dense input f[b, m2*P2*P2 + i*P2 + j].
__global__ void k_conv2_pool(Dims d, const float* __restrict__ p1,
                             const float* __restrict__ w2,
                             const float* __restrict__ b2,
                             float* __restrict__ z2, float* __restrict__ f) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= d.B * d.M2 * d.P2 * d.P2) return;
  const int F = d.F2, M1 = d.M1, P1 = d.P1;
  int j = idx % d.P2, i = (idx / d.P2) % d.P2;
  int m = (idx / (d.P2 * d.P2)) % d.M2, b = idx / (d.P2 * d.P2 * d.M2);
  const float* wm = w2 + m * F * F * M1;
  float best = -INFINITY;
  for (int dy = 0; dy < d.pool2; ++dy) {
    int y = i * d.pool2 + dy;
    if (y >= d.c2) break;
    for (int dx = 0; dx < d.pool2; ++dx) {
      int xx = j * d.pool2 + dx;
      if (xx >= d.c2) break;
      float acc = 0.0f;   // tap order and rounding shared with the twin
      for (int u = 0; u < F; ++u)
        for (int v = 0; v < F; ++v)
          for (int c = 0; c < M1; ++c)
            acc = __fadd_rn(acc, __fmul_rn(
                wm[(u * F + v) * M1 + c],
                p1[((b * M1 + c) * P1 + y + F - 1 - u) * P1
                   + (xx + F - 1 - v)]));
      float z = acc + b2[m];
      z2[((b * d.M2 + m) * d.c2 + y) * d.c2 + xx] = z;
      best = fmaxf(best, act_fn(z, d.act2, d.slope2));
    }
  }
  f[idx] = best;  // idx == b*NF + m*P2*P2 + i*P2 + j
}

// The dense tail's head, in stages that each spread over the card (no
// stage holds a batch-wide view in one block, none adds floats atomically,
// every sum runs in one fixed order):
//   (before it)    z3 = f wh + bh (stages.cuh gemm) with the epilogue
//                  h3d = dropout(act_h(z3));
//   k_head_scores  the scores' products z4 = h3d wo as HEAD_KS-wide slices
//                  of K = NH (split-K), one tile and slice a block;
//   k_head_loss    one block a sample: its row of NC scores (the slices
//                  added in order, then bo), max and sum of exp by block
//                  reductions, the log-probs, dL/dz4 and the true-class
//                  log-prob;
//   k_head_bwd     dwo = h3d^T dz4 (split-K over the batch when it is long)
//                  and dz3 = (dz4 wo^T) * mask * act_h'(z3), tiled GEMMs in
//                  one launch;
//   k_head_finish  (cost, minf) over the per-sample terms, the column sums
//                  dbo (over dz4) and dbh (over dz3), and dwo's slices added
//                  in order.
// The last three start by programmatic dependent launch (launch_pdl): at
// mnist_cnn's 20 x 10 head each stage runs a few microseconds, about its
// launch latency. The dropout test is !(u01(db) >= pdrop) and a dropped
// unit is 0 * h (a NaN or inf still propagates; no rescale); a label
// outside [0, NC) gives a NaN cost.
constexpr int HEAD_KS = 64;    // K = NH per scores slice
constexpr int HEAD_KB = 256;   // K = B per dwo slice

__device__ __forceinline__ bool dropped(const Dims& d, const int* db, int e) {
  return d.pdrop > 0.0f && !(u01(db[e]) >= d.pdrop);
}

// part[s] (B, NC) = h3d[:, K_s] wo[K_s, :] over slice s = blockIdx.z of
// K = NH.
__global__ void k_head_scores(Dims d, const float* __restrict__ h3d,
                              const float* __restrict__ wo,
                              float* __restrict__ part) {
  pdl_trigger();
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const int kb = blockIdx.z * HEAD_KS, ke = min(d.NH, kb + HEAD_KS);
  float acc = gemm_tile<false, false>(d.B, d.NC, kb, ke, h3d, d.NH, wo, d.NC,
                                      m0, n0);
  const int m = m0 + threadIdx.y, n = n0 + threadIdx.x;
  if (m < d.B && n < d.NC)
    part[((size_t)blockIdx.z * d.B + m) * d.NC + n] = acc;
}

// Sample b = blockIdx.x: z4 = sum of the ``ns`` slices (in order) + bo,
// log-softmax, dz4[b, :] = (exp(lp) - onehot) / B and tl[b] = the
// true-class log-prob (NaN for a label outside [0, NC)). The row's scores
// are kept in dz4's row (read back by the thread that wrote them).
__global__ void __launch_bounds__(HEAD_T)
k_head_loss(Dims d, int ns, const float* __restrict__ part,
            const float* __restrict__ bo, const int* __restrict__ y,
            float* __restrict__ dz4, float* __restrict__ tl) {
  pdl_wait();
  pdl_trigger();
  __shared__ float red[32];
  const int b = blockIdx.x, B = d.B, NC = d.NC;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* row = dz4 + (size_t)b * NC;
  float mx = -INFINITY;
  for (int c = tid; c < NC; c += nt) {
    float z = 0.0f;
    for (int s = 0; s < ns; ++s) z += part[((size_t)s * B + b) * NC + c];
    z = z + bo[c];
    row[c] = z;
    mx = fmaxf(mx, z);
  }
  mx = block_extreme<false>(mx, red);
  float se = 0.0f;
  for (int c = tid; c < NC; c += nt) se += expf(row[c] - mx);
  const float lse = logf(block_sum(se, red));
  const int yb = y[b];
  const float invB = 1.0f / (float)B;
  if (tid == 0 && !(yb >= 0 && yb < NC)) tl[b] = NAN;
  for (int c = tid; c < NC; c += nt) {
    const float lp = (row[c] - mx) - lse;
    if (c == yb) tl[b] = lp;
    row[c] = (expf(lp) - (c == yb ? 1.0f : 0.0f)) * invB;
  }
}

// dwo (or its slices, ``sw`` > 1: K = B cut at HEAD_KB) then dz3 with its
// epilogue: the first NC/16 x NH/16 x sw blocks are dwo's tiles, the rest
// dz3's.
__global__ void k_head_bwd(Dims d, int sw, const float* __restrict__ h3d,
                           const float* __restrict__ dz4,
                           const float* __restrict__ wo,
                           const float* __restrict__ z3,
                           const int* __restrict__ db,
                           float* __restrict__ gwo, float* __restrict__ dz3) {
  pdl_wait();
  pdl_trigger();
  const int B = d.B, NH = d.NH, NC = d.NC;
  const int tnc = cdiv(NC, TILE), tnh = cdiv(NH, TILE);
  const int nwo = tnc * tnh * sw;
  int blk = blockIdx.x;
  if (blk < nwo) {
    const int s = blk / (tnc * tnh), r = blk % (tnc * tnh);
    const int m0 = (r / tnc) * TILE, n0 = (r % tnc) * TILE;
    const int kb = s * HEAD_KB, ke = min(B, kb + HEAD_KB);
    float acc = gemm_tile<true, false>(NH, NC, kb, ke, h3d, NH, dz4, NC, m0,
                                       n0);
    const int m = m0 + threadIdx.y, n = n0 + threadIdx.x;
    if (m < NH && n < NC) gwo[((size_t)s * NH + m) * NC + n] = acc;
    return;
  }
  blk -= nwo;
  const int m0 = (blk / tnh) * TILE, n0 = (blk % tnh) * TILE;
  float acc = gemm_tile<false, true>(B, NH, 0, NC, dz4, NC, wo, NC, m0, n0);
  const int m = m0 + threadIdx.y, n = n0 + threadIdx.x;
  if (m >= B || n >= NH) return;
  const int e = m * NH + n;
  if (dropped(d, db, e)) acc = 0.0f * acc;
  dz3[e] = acc * dact_fn(z3[e], d.acth, d.slopeh);
}

// Block 0: cm = (-sum(tl) / B + wcost, min(tl)); then NC/32 blocks of dbo,
// NH/32 of dbh (block_colsum32), and, when dwo came in ``sw`` > 1 slices,
// a thread an element adding them in order.
__global__ void __launch_bounds__(COLSUM_THREADS)
k_head_finish(Dims d, int sw, const float* __restrict__ tl,
              const float* __restrict__ dz4, const float* __restrict__ dz3,
              const float* __restrict__ wpart,
              const float* __restrict__ wcost, float* __restrict__ gwo,
              float* __restrict__ gbo, float* __restrict__ gbh,
              float* __restrict__ cm) {
  pdl_wait();
  __shared__ float red[32];
  const int B = d.B, NH = d.NH, NC = d.NC;
  int blk = blockIdx.x;
  if (blk == 0) {
    float s = 0.0f, mn = INFINITY;
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      s += tl[b];
      mn = fminf(mn, tl[b]);
    }
    s = block_sum(s, red);
    mn = block_extreme<true>(mn, red);
    if (threadIdx.x == 0) {
      cm[0] = -s / (float)B + (wcost ? wcost[0] : 0.0f);
      cm[1] = mn;
    }
    return;
  }
  blk -= 1;
  if (blk < cdiv(NC, 32)) {
    block_colsum32(B, NC, dz4, blk * 32, gbo);
    return;
  }
  blk -= cdiv(NC, 32);
  if (blk < cdiv(NH, 32)) {
    block_colsum32(B, NH, dz3, blk * 32, gbh);
    return;
  }
  blk -= cdiv(NH, 32);
  const int e = blk * blockDim.x + threadIdx.x;
  if (e >= NH * NC) return;
  float s = 0.0f;
  for (int k = 0; k < sw; ++k) s += wpart[(size_t)k * NH * NC + e];
  gwo[e] = s;
}

// pool2 backward + act2': one thread per conv2 output position.
__global__ void k_pool2_bwd(Dims d, const float* __restrict__ z2,
                            const float* __restrict__ f,
                            const float* __restrict__ df,
                            float* __restrict__ dz2) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= d.B * d.M2 * d.c2 * d.c2) return;
  int x = idx % d.c2, y = (idx / d.c2) % d.c2;
  int m = (idx / (d.c2 * d.c2)) % d.M2, b = idx / (d.c2 * d.c2 * d.M2);
  float g = 0.0f;
  if (y < d.e2 && x < d.e2) {
    float z = z2[idx];
    int o = b * d.NF + m * d.P2 * d.P2 + (y / d.pool2) * d.P2 + x / d.pool2;
    if (act_fn(z, d.act2, d.slope2) == f[o])
      g = df[o] * dact_fn(z, d.act2, d.slope2);
  }
  dz2[idx] = g;
}

// conv2 input gradient (stages.cuh dgrad_stage / dgrad_sum: a block a row
// band of pooled1 rows, map m1 and sample, the taps on a zero-padded copy
// of the sample's dz2) + pool1 backward + act1': a thread a pooled1
// position; it writes dz1 to every member of its window equal to the
// window's max.
__global__ void k_conv2_dgrad_pool1_bwd(Dims d, ConvGeom g, DgradPlan p,
                                        const float* __restrict__ w2,
                                        const float* __restrict__ dz2,
                                        const float* __restrict__ z1,
                                        const float* __restrict__ p1,
                                        float* __restrict__ dz1) {
  const int n = dgrad_stage(g, p, w2, dz2);
  const int m1 = blockIdx.y, b = blockIdx.z, M1 = d.M1;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const float dp = dgrad_sum(g, p, t);
    const int i = blockIdx.x * p.rows + t / d.P1, j = t % d.P1;
    const float mx = p1[((b * M1 + m1) * d.P1 + i) * d.P1 + j];
    for (int dy = 0; dy < d.pool1; ++dy) {
      int y = i * d.pool1 + dy;
      if (y >= d.c1) break;
      for (int dx = 0; dx < d.pool1; ++dx) {
        int x = j * d.pool1 + dx;
        if (x >= d.c1) break;
        int zi = ((b * M1 + m1) * d.c1 + y) * d.c1 + x;
        float z = z1[zi];
        dz1[zi] = act_fn(z, d.act1, d.slope1) == mx
                      ? dp * dact_fn(z, d.act1, d.slope1) : 0.0f;
      }
    }
  }
}

struct Workspace {
  float *tyx, *a, *z1, *p1, *z2, *f, *z3, *h3d, *dz3, *df, *dz2, *dz1,
      *grads, *wcost, *wpart;
  float *sparts, *dz4, *tl, *wparts;   // the head's: scores' slices, dL/dz4,
                                       // per-sample terms, dwo's slices
  float *wgparts, *gparts;   // the conv weight gradients' slices, the
                             // products' K slices
  unsigned* ctr;   // the products' tile counters, then the weight
  long long nctr;  // gradients' (zeroed at each entry: zero_counters)
  long long total;
};

// The head's slice counts: of the scores' K = NH, of dwo's K = B (1: dwo
// is written whole).
int score_slices(const Dims& d) { return cdiv(d.NH, HEAD_KS); }
int dwo_slices(const Dims& d) { return cdiv(d.B, HEAD_KB); }

// The two conv levels for the gradient stages (stages.cuh ConvGeom): conv2
// reads pooled1 (B, M1, P1, P1); conv1 the channel-major augmented rows
// (c*B + b, HW).
ConvGeom conv2_geom(const Dims& d) {
  return {d.B, d.M2, d.M1, d.F2, d.c2, d.e2, 1, 0, d.P1,
          d.M1 * d.P1 * d.P1, d.P1 * d.P1};
}
ConvGeom conv1_geom(const Dims& d) {
  return {d.B, d.M1, d.C0, d.F1, d.c1, d.e1, 1, 0, d.H, d.HW, d.B * d.HW};
}

Workspace carve(const Dims& d, float* base) {
  Workspace w;
  long long o = 0;
  auto take = [&](long long n) { float* p = base ? base + o : nullptr; o += n; return p; };
  w.tyx = take(2LL * d.HW);
  w.a = take((long long)d.C0 * d.B * d.HW);
  w.z1 = take((long long)d.B * d.M1 * d.c1 * d.c1);
  w.p1 = take((long long)d.B * d.M1 * d.P1 * d.P1);
  w.z2 = take((long long)d.B * d.M2 * d.c2 * d.c2);
  w.f = take((long long)d.B * d.NF);
  w.z3 = take((long long)d.B * d.NH);
  w.h3d = take((long long)d.B * d.NH);
  w.dz3 = take((long long)d.B * d.NH);
  w.df = take((long long)d.B * d.NF);
  w.dz2 = take((long long)d.B * d.M2 * d.c2 * d.c2);
  w.dz1 = take((long long)d.B * d.M1 * d.c1 * d.c1);
  long long np = (long long)d.M1 * d.F1 * d.F1 * d.C0 + d.M1
                 + (long long)d.M2 * d.F2 * d.F2 * d.M1 + d.M2
                 + (long long)d.NF * d.NH + d.NH + (long long)d.NH * d.NC
                 + d.NC;
  w.grads = take(np);
  w.wcost = take(1);
  w.wpart = take(WCOST_BLOCKS);
  w.sparts = take((long long)score_slices(d) * d.B * d.NC);
  w.dz4 = take((long long)d.B * d.NC);
  w.tl = take(d.B);
  const int sw = dwo_slices(d);
  w.wparts = take(sw > 1 ? (long long)sw * d.NH * d.NC : 0);
  const ConvGeom g2 = conv2_geom(d), g1 = conv1_geom(d);
  w.wgparts = take(std::max(wgrad_part_floats(g2), wgrad_part_floats(g1)));
  w.gparts = take(GEMM_PART_CAP);
  w.nctr = GEMM_TARGET + std::max(wgrad_counters(g2), wgrad_counters(g1));
  w.ctr = (unsigned*)take(w.nctr);
  w.total = o;
  return w;
}

// Element counts of the 8 state tensors, in layout order; the flat
// gradient buffer holds them back to back.
void state_sizes(const Dims& d, int sizes[8]) {
  const int s[8] = {d.M1 * d.F1 * d.F1 * d.C0, d.M1,
                    d.M2 * d.F2 * d.F2 * d.M1, d.M2,
                    d.NF * d.NH, d.NH, d.NH * d.NC, d.NC};
  for (int k = 0; k < 8; ++k) sizes[k] = s[k];
}

// One step's slice of the data and noise words.
struct StepIn {
  const float* x;
  const int *y, *ub, *fb, *pb, *db;
};

// What every step of a call shares: the shapes, the warp and augmentation
// settings, the workspace, the parameters and the weight-cost table.
struct StepCtx {
  Dims d;
  Workspace w;
  WarpParams wp;
  int warp, nearest, invert;
  float pflip;
  size_t warp_smem;
  const float *gh, *gw;
  float* prm[8];
  WcostTable t8;
  bool any_wcost;
};

// 0, or -1 when the warp stage needs more shared memory than a block can
// have (megastep_error_string).
int step_setup(const int* is, const float* fs, float* ws, const float* gh,
               const float* gw, void* const* prm, StepCtx* c) {
  c->d = make_dims(is, fs);
  const Dims& d = c->d;
  c->w = carve(d, ws);
  c->gh = gh;
  c->gw = gw;
  WarpParams& wp = c->wp;
  wp.trans = is[I_TRANS]; wp.mag = is[I_MAG]; wp.zoom = is[I_ZOOM];
  wp.angle = is[I_ANGLE];
  wp.translation = fs[F_TRANS]; wp.logzoom = fs[F_LOGZOOM];
  wp.magnitude = fs[F_MAG]; wp.angle_rad = fs[F_ANGLE];
  wp.clip_hi = fs[F_CLIPHI];
  c->warp = wp.trans || wp.mag || wp.zoom || wp.angle;
  c->nearest = is[I_NEAREST];
  c->invert = is[I_INVERT];
  c->pflip = is[I_PFLIP] ? fs[F_PFLIP] : 0.0f;
  c->warp_smem = 4 * sizeof(float) * (size_t)d.HW;
  if (c->warp && !warp_smem_ok(c->warp_smem)) return -1;
  int sizes[8];
  state_sizes(d, sizes);
  const float* reg = fs + F_REG0;  // conv1, conv2, hidden, out
  c->t8.count = 8;
  c->any_wcost = false;
  for (int k = 0; k < 8; ++k) {
    const float* r = reg + (k / 2) * N_REG;
    c->prm[k] = (float*)prm[k];
    c->t8.p[k] = c->prm[k];
    c->t8.n[k] = sizes[k];
    c->t8.L1[k] = r[R_L1];
    c->t8.L2[k] = r[R_L2];
    c->any_wcost = c->any_wcost || r[R_L1] != 0.0f || r[R_L2] != 0.0f;
  }
  return 0;
}

// One step's augmentation, forward and hand-derived backward at the
// parameters of ``c``: (cost, minf) to cm[0:2] and the data gradients
// (no L1/L2 term, no update) to the flat buffer ``grads`` (state_sizes).
// The epoch entry and the data-parallel step entry both run it.
int grad_stages(const StepCtx& c, cudaStream_t s, const StepIn& in,
                float* grads, float* cm) {
  const Dims& d = c.d;
  const Workspace& w = c.w;
  float* const* prm = c.prm;
  int sizes[8];
  state_sizes(d, sizes);
  float* grad[8];
  for (int k = 0; k < 8; ++k) { grad[k] = grads; grads += sizes[k]; }
  const int T = 256;
  if (c.warp) {
    k_warp<<<1, 256, c.warp_smem, s>>>(d.H, c.wp, in.ub, in.fb, c.gh, c.gw,
                                        w.tyx);
    LAUNCHED();
  }
  k_augment<<<blocks((long long)d.C0 * d.B * d.HW, T), T, 0, s>>>(
      d, c.warp, c.nearest, c.invert, c.pflip, in.x, w.tyx, in.pb, w.a);
  LAUNCHED();
  k_conv1_pool<<<blocks((long long)d.B * d.M1 * d.P1 * d.P1, T), T, 0, s>>>(
      d, w.a, prm[0], prm[1], w.z1, w.p1);
  LAUNCHED();
  k_conv2_pool<<<blocks((long long)d.B * d.M2 * d.P2 * d.P2, T), T, 0, s>>>(
      d, w.p1, prm[2], prm[3], w.z2, w.f);
  LAUNCHED();
  CHECK((gemm<false, false>(s, d.B, d.NH, d.NF, w.f, d.NF, prm[4], d.NH,
                            hidden_out(w.z3, d.NH, prm[5], w.h3d, d.acth,
                                       d.slopeh, d.pdrop, in.db, d.NH, 0),
                            w.gparts, w.ctr)));
  if (c.any_wcost) CHECK(wcost(s, c.t8, w.wpart, w.wcost));
  const float* wc = c.any_wcost ? w.wcost : nullptr;
  const int ns = score_slices(d), sw = dwo_slices(d);
  const dim3 tile(TILE, TILE);
  k_head_scores<<<dim3(cdiv(d.NC, TILE), cdiv(d.B, TILE), ns), tile, 0, s>>>(
      d, w.h3d, prm[6], w.sparts);
  LAUNCHED();
  CHECK(launch_pdl(k_head_loss, dim3(d.B), dim3(HEAD_T), s, d, ns, w.sparts,
                   prm[7], in.y, w.dz4, w.tl));
  const int nwo = cdiv(d.NC, TILE) * cdiv(d.NH, TILE) * sw;
  CHECK(launch_pdl(k_head_bwd, dim3(nwo + cdiv(d.B, TILE) * cdiv(d.NH, TILE)),
                   tile, s, d, sw, w.h3d, w.dz4, prm[6], w.z3, in.db,
                   sw > 1 ? w.wparts : grad[6], w.dz3));
  const int nfin = 1 + cdiv(d.NC, 32) + cdiv(d.NH, 32)
                   + (sw > 1 ? cdiv(d.NH * d.NC, COLSUM_THREADS) : 0);
  CHECK(launch_pdl(k_head_finish, dim3(nfin), dim3(COLSUM_THREADS), s, d, sw,
                   w.tl, w.dz4, w.dz3, w.wparts, wc, grad[6], grad[7],
                   grad[5], cm));
  // dwh = f^T dz3 ; df = dz3 wh^T
  CHECK((gemm<true, false>(s, d.NF, d.NH, d.B, w.f, d.NF, w.dz3, d.NH,
                           gemm_out(grad[4], d.NH), w.gparts, w.ctr)));
  CHECK((gemm<false, true>(s, d.B, d.NF, d.NH, w.dz3, d.NH, prm[4], d.NH,
                           gemm_out(w.df, d.NF), w.gparts, w.ctr)));
  k_pool2_bwd<<<blocks((long long)d.B * d.M2 * d.c2 * d.c2, T), T, 0, s>>>(
      d, w.z2, w.f, w.df, w.dz2);
  LAUNCHED();
  const ConvGeom g2 = conv2_geom(d);
  int rc = conv_wgrad(s, g2, w.dz2, w.p1, w.wgparts, w.ctr + GEMM_TARGET,
                      grad[2], grad[3]);
  if (rc != 0) return rc;
  const DgradPlan dg = dgrad_plan(d.B, d.M1, d.P1, d.M2, d.F2);
  const size_t dsm = sizeof(float) * dg.smem_floats;
  if (!smem_opt_in(k_conv2_dgrad_pool1_bwd, dsm)) return ERR_STAGE_SMEM;
  CHECK(launch_pdl(k_conv2_dgrad_pool1_bwd, dim3(dg.nbands, d.M1, d.B),
                   dim3(dg.threads), dsm, s, d, g2, dg, prm[2], w.dz2, w.z1,
                   w.p1, w.dz1));
  return conv_wgrad(s, conv1_geom(d), w.dz1, w.a, w.wgparts,
                    w.ctr + GEMM_TARGET, grad[0], grad[1]);
}

// L1/L2 gradient, old-accumulator momentum step and max-norm of the 8 state
// tensors from the flat gradient buffer ``grads``, in place. The epoch
// entry and the data-parallel update entry both run it.
int update_stages(const int* is, const float* fs, float* const* prm,
                  float* const* mom, const float* grads, float lr,
                  cudaStream_t s) {
  const Dims d = make_dims(is, fs);
  int sizes[8];
  state_sizes(d, sizes);
  const float* reg = fs + F_REG0;  // conv1, conv2, hidden, out
  UpdateTable ut;
  ut.count = 8;
  ut.off[0] = 0;
  for (int k = 0; k < 8; ++k) {
    const float* r = reg + (k / 2) * N_REG;
    ut.p[k] = prm[k];
    ut.a[k] = mom[k];
    ut.g[k] = grads + ut.off[k];
    ut.off[k + 1] = ut.off[k] + sizes[k];
    ut.L1[k] = r[R_L1];
    ut.L2x2[k] = r[R_L2X2];
    ut.mom[k] = r[R_MOM];
    ut.omm[k] = r[R_OMM];
    ut.rate[k] = r[R_RATE];
    ut.clip[k] = (k % 2 == 1) ? r[R_MAXNORM] : 0.0f;  // biases clip
  }
  const int T = 256;
  k_update<<<blocks(ut.off[8], T), T, 0, s>>>(ut, lr);
  LAUNCHED();
  for (int k = 0; k < 8; k += 2) {   // weight max-norm (biases clipped)
    float mn = reg[(k / 2) * N_REG + R_MAXNORM];
    if (mn == 0.0f || reg[(k / 2) * N_REG + R_RATE] == 0.0f) continue;
    if (k < 4) {
      int rows = k == 0 ? d.M1 : d.M2;
      k_maxnorm_rows<<<rows, T, 0, s>>>(prm[k], sizes[k] / rows, mn);
    } else {
      int cols = k == 4 ? d.NH : d.NC;
      k_maxnorm_cols<<<blocks(cols, T), T, 0, s>>>(prm[k], sizes[k] / cols,
                                                   cols, mn);
    }
    LAUNCHED();
  }
  return 0;
}

// The epoch loop of megastep_epoch (``R`` null) and megastep_ring_epoch:
// grad_stages, at a data-parallel rank the ring exchange (into the
// workspace's gradient buffer and cost_minf), then update_stages, a step.
int epoch_loop(const int* is, const float* fs, void* const* ptrs,
               int n_steps, float lr, float* ws, Ring* R, int device,
               cudaStream_t s) {
  CHECK(cudaSetDevice(device));
  StepCtx c;
  int rc = step_setup(is, fs, ws, (const float*)ptrs[P_GH],
                      (const float*)ptrs[P_GW], ptrs + P_PARAMS, &c);
  if (rc != 0) return rc;
  CHECK(zero_counters(c.w.ctr, c.w.nctr, s));
  const Dims& d = c.d;
  float* mom[8];
  for (int k = 0; k < 8; ++k) mom[k] = (float*)ptrs[P_MOMS + k];
  float* cm = (float*)ptrs[P_CM];
  int sizes[8];
  state_sizes(d, sizes);
  long long ng = 0;
  for (int k = 0; k < 8; ++k) ng += sizes[k];
  const bool ring = R && R->n > 1;
  for (int st = 0; st < n_steps; ++st) {
    StepIn in;
    in.x = (const float*)ptrs[P_X] + (size_t)st * d.C0 * d.B * d.HW;
    in.y = (const int*)ptrs[P_Y] + (size_t)st * d.B;
    in.ub = (const int*)ptrs[P_UB] + (size_t)st * 8;
    in.fb = (const int*)ptrs[P_FB] + (size_t)st * 4 * d.HW;
    in.pb = (const int*)ptrs[P_PB] + (size_t)st * d.C0 * d.B * d.HW;
    in.db = (const int*)ptrs[P_DB] + (size_t)st * d.B * d.NH;
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
    rc = update_stages(is, fs, c.prm, mom, c.w.grads, lr, s);
    if (rc != 0) return rc;
  }
  return ring ? ring_finish(*R, s) : 0;
}

}  // namespace

extern "C" {

// Floats of scratch the wrapper must allocate for one epoch or step call.
long long megastep_workspace_floats(const int* ispec, const float* fspec) {
  return carve(make_dims(ispec, fspec), nullptr).total;
}

const char* megastep_error_string(int code) {
  if (const char* r = ring_error_string(code)) return r;
  if (code == -1) return "warp field needs more shared memory than a block has";
  if (code == ERR_STAGE_SMEM) return stage_smem_error;
  return cudaGetErrorString((cudaError_t)code);
}

// One epoch: n_steps steps on ``stream`` of ``device``; parameters and
// momentum in the pointer table are updated in place, cost_minf (n_steps, 2)
// is written. Returns 0, or the first CUDA error (the launch that failed
// never ran).
int megastep_epoch(const int* is, const float* fs, void* const* ptrs,
                   int n_steps, float lr, float* ws, int device,
                   void* stream_) {
  return epoch_loop(is, fs, ptrs, n_steps, lr, ws, nullptr, device,
                    (cudaStream_t)stream_);
}

// One data-parallel rank's epoch (the port of megastep_ring.py's
// _kernel_ring at the flagship): megastep_epoch's pointer table on the
// rank's shard of the data and words, and the ring table of
// ops/megastep_ring.py (csrc/ring.cuh Ring); ``launched`` receives the
// number of exchange kernels launched. Returns 0, a ring error (RING_ERR_*,
// after the epoch) or the first CUDA error.
int megastep_ring_epoch(const int* is, const float* fs, void* const* ptrs,
                        int n_steps, float lr, float* ws,
                        const long long* ring, long long* launched, int device,
                        void* stream_) {
  Ring R;
  int rc = ring_parse(ring, &R);
  if (rc != 0) return rc;
  rc = epoch_loop(is, fs, ptrs, n_steps, lr, ws, &R, device,
                  (cudaStream_t)stream_);
  *launched = R.launched;
  return rc;
}

// One data-parallel step's gradient (the port of megastep_dp.py's
// _kernel_grad at the flagship): grad_stages on one step's inputs, pointer
// table x, y, ub, fb, pb, db, gh, gw, the 8 parameters, the flat gradient
// buffer and cost_minf (2,). Parameters are read only.
int megastep_grad_step(const int* is, const float* fs, void* const* ptrs,
                       float* ws, int device, void* stream_) {
  CHECK(cudaSetDevice(device));
  StepCtx c;
  int rc = step_setup(is, fs, ws, (const float*)ptrs[P_GH],
                      (const float*)ptrs[P_GW], ptrs + P_PARAMS, &c);
  if (rc != 0) return rc;
  CHECK(zero_counters(c.w.ctr, c.w.nctr, (cudaStream_t)stream_));
  StepIn in;
  in.x = (const float*)ptrs[P_X];
  in.y = (const int*)ptrs[P_Y];
  in.ub = (const int*)ptrs[P_UB];
  in.fb = (const int*)ptrs[P_FB];
  in.pb = (const int*)ptrs[P_PB];
  in.db = (const int*)ptrs[P_DB];
  return grad_stages(c, (cudaStream_t)stream_, in,
                     (float*)ptrs[P_PARAMS + 8], (float*)ptrs[P_PARAMS + 9]);
}

// The update after the gradient all-reduce: update_stages with pointer table
// the 8 parameters, the 8 momenta and the flat gradient buffer.
int megastep_update(const int* is, const float* fs, void* const* ptrs,
                    float lr, int device, void* stream_) {
  CHECK(cudaSetDevice(device));
  return update_stages(is, fs, (float* const*)ptrs, (float* const*)ptrs + 8,
                       (const float*)ptrs[16], lr, (cudaStream_t)stream_);
}

}  // extern "C"

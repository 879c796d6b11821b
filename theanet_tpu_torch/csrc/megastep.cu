// Whole-epoch fused training of the 2-conv flagship net, for Hopper (sm_90a).
//
// Replaces theanet_tpu/ops/megastep.py::_kernel (the Pallas epoch kernel,
// built by make_epoch_fn / build_epoch_fn). Its plain PyTorch twin, which
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
// What the design does about it (the simplest correct form, first): one C
// call per epoch loops the steps on the caller's stream and launches 13
// small stage kernels per step (fewer when the config has no warp, weight
// cost or max-norm). Each stage is one thread per output element, or one
// block per reduction, sized so that every stage puts at least a few
// thousand threads on the card; the dense products use one hand-written
// 16x16 shared-memory tiled GEMM; the softmax head and its backward run in
// one block. Nothing is computed by a library kernel. Fewer stages
// (persistent kernels, CUDA graphs, wgmma) are later work; PERF.md has the
// measured times.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
enum { R_L1, R_L2X2, R_L2, R_MOM, R_OMM, R_RATE, R_MAXNORM, N_REG };
// ---- pointer table
enum {
  P_X, P_Y, P_UB, P_FB, P_PB, P_DB, P_GH, P_GW, P_PARAMS,
  P_MOMS = P_PARAMS + 8, P_CM = P_MOMS + 8, N_PTRS
};

constexpr int MASK24 = 0xFFFFFF;
constexpr float INV24 = 1.0f / 16777216.0f;
constexpr float TWO_PI = 6.28318530717958647692f;
constexpr int ACT_LEAKY = 0, ACT_TANH = 1, ACT_STANH = 2, ACT_SIGMOID = 3,
              ACT_SOFTPLUS = 4;

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

__device__ __forceinline__ float u01(int bits) {
  return (float)(bits & MASK24) * INV24;
}

__device__ __forceinline__ float act_fn(float z, int kind, float slope) {
  switch (kind) {
    case ACT_LEAKY: return fmaxf(z, 0.0f) + fminf(z, 0.0f) * slope;
    case ACT_TANH: return tanhf(z);
    case ACT_STANH: return 1.7f * tanhf(z * (2.0f / 3.0f));
    case ACT_SIGMOID: return 1.0f / (1.0f + expf(-z));
    default: return fmaxf(z, 0.0f) + logf(1.0f + expf(-fabsf(z)));
  }
}

__device__ __forceinline__ float dact_fn(float z, int kind, float slope) {
  switch (kind) {
    case ACT_LEAKY: return z > 0.0f ? 1.0f : slope;
    case ACT_TANH: { float t = tanhf(z); return 1.0f - t * t; }
    case ACT_STANH: {
      float t = tanhf(z * (2.0f / 3.0f));
      return (1.7f * 2.0f / 3.0f) * (1.0f - t * t);
    }
    case ACT_SIGMOID: {
      float s = 1.0f / (1.0f + expf(-z));
      return s * (1.0f - s);
    }
    default: return 1.0f / (1.0f + expf(-z));
  }
}

struct WarpParams {
  int trans, mag, zoom, angle;
  float translation, logzoom, magnitude, angle_rad, clip_hi;
};

// The step's shared warp target (ty, tx) -> tyx[0:HW], tyx[HW:2HW].
// One block; dynamic shared memory holds the two noise fields and their
// half-smoothed products (4*HW floats).
__global__ void k_warp(Dims d, WarpParams w, const int* __restrict__ ub,
                       const int* __restrict__ fb, const float* __restrict__ gh,
                       const float* __restrict__ gw, float* __restrict__ tyx) {
  extern __shared__ float sm[];
  const int H = d.H, HW = d.HW;
  float* n0 = sm;
  float* n1 = sm + HW;
  float* t0 = sm + 2 * HW;
  float* t1 = sm + 3 * HW;
  float u[8];
  for (int j = 0; j < 8; ++j) u[j] = 2.0f * u01(ub[j]) - 1.0f;

  if (w.mag) {
    for (int p = threadIdx.x; p < HW; p += blockDim.x) {
      float u1a = ((float)(fb[p] & MASK24) + 0.5f) * INV24;
      float u2a = u01(fb[HW + p]);
      float u1b = ((float)(fb[2 * HW + p] & MASK24) + 0.5f) * INV24;
      float u2b = u01(fb[3 * HW + p]);
      n0[p] = w.magnitude * (sqrtf(-2.0f * logf(u1a)) * cosf(TWO_PI * u2a));
      n1[p] = w.magnitude * (sqrtf(-2.0f * logf(u1b)) * sinf(TWO_PI * u2b));
    }
    __syncthreads();
    for (int p = threadIdx.x; p < HW; p += blockDim.x) {  // T = G_h @ N
      int i = p / H, j = p % H;
      float a0 = 0.0f, a1 = 0.0f;
      for (int k = 0; k < H; ++k) {
        float g = gh[i * H + k];
        a0 += g * n0[k * H + j];
        a1 += g * n1[k * H + j];
      }
      t0[p] = a0;
      t1[p] = a1;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < HW; p += blockDim.x) {  // S = T @ G_w^T
      int i = p / H, j = p % H;
      float a0 = 0.0f, a1 = 0.0f;
      for (int k = 0; k < H; ++k) {
        float g = gw[j * H + k];
        a0 += t0[i * H + k] * g;
        a1 += t1[i * H + k] * g;
      }
      n0[p] = a0;   // n0/n1 are no longer read: reuse them for S
      n1[p] = a1;
    }
    __syncthreads();
  }

  for (int p = threadIdx.x; p < HW; p += blockDim.x) {
    float ty = (float)(p / H), tx = (float)(p % H);
    if (w.trans) {
      ty = ty + w.translation * u[0];
      tx = tx + w.translation * u[1];
    }
    if (w.mag) {
      ty = ty + n0[p];
      tx = tx + n1[p];
    }
    if (w.zoom || w.angle) {
      float oy = (0.5f + 0.25f * u[2]) * (float)H;
      float ox = (0.5f + 0.25f * u[3]) * (float)H;
      ty = ty - oy;
      tx = tx - ox;
      if (w.zoom) {
        ty = ty * expf(w.logzoom * u[4]);
        tx = tx * expf(w.logzoom * u[5]);
      }
      if (w.angle) {
        float th = w.angle_rad * u[6];
        float ct = cosf(th), st = sinf(th);
        float ny = ct * ty + st * tx;
        float nx = -st * ty + ct * tx;
        ty = ny;
        tx = nx;
      }
      ty = ty + oy;
      tx = tx + ox;
    }
    tyx[p] = fminf(fmaxf(ty, 0.0f), w.clip_hi);
    tyx[HW + p] = fminf(fmaxf(tx, 0.0f), w.clip_hi);
  }
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

// C[M,N] = A(M,K) @ B(K,N) (+ bias[N]); A(m,k) = TA ? A[k*lda+m] : A[m*lda+k],
// B(k,n) = TB ? B[n*ldb+k] : B[k*ldb+n]. 16x16 shared-memory tiles, loads
// coalesced along the stored rows in every transpose case.
constexpr int TILE = 16;

template <bool TA, bool TB>
__global__ void k_gemm(int M, int N, int K, const float* __restrict__ A,
                       int lda, const float* __restrict__ Bm, int ldb,
                       const float* __restrict__ bias, float* __restrict__ C,
                       int ldc) {
  __shared__ float As[TILE][TILE + 1];  // As[m][k]
  __shared__ float Bs[TILE][TILE + 1];  // Bs[k][n]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += TILE) {
    if (TA) {
      int m = m0 + tx, k = k0 + ty;
      As[tx][ty] = (m < M && k < K) ? A[(size_t)k * lda + m] : 0.0f;
    } else {
      int m = m0 + ty, k = k0 + tx;
      As[ty][tx] = (m < M && k < K) ? A[(size_t)m * lda + k] : 0.0f;
    }
    if (TB) {
      int n = n0 + ty, k = k0 + tx;
      Bs[tx][ty] = (n < N && k < K) ? Bm[(size_t)n * ldb + k] : 0.0f;
    } else {
      int k = k0 + ty, n = n0 + tx;
      Bs[ty][tx] = (n < N && k < K) ? Bm[(size_t)k * ldb + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE; ++kk) acc += As[ty][kk] * Bs[kk][tx];
    __syncthreads();
  }
  int m = m0 + ty, n = n0 + tx;
  if (m < M && n < N) C[(size_t)m * ldc + n] = bias ? acc + bias[n] : acc;
}

template <bool TA, bool TB>
cudaError_t gemm(cudaStream_t s, int M, int N, int K, const float* A,
                 int lda, const float* Bm, int ldb, const float* bias,
                 float* C) {
  dim3 block(TILE, TILE), grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  k_gemm<TA, TB><<<grid, block, 0, s>>>(M, N, K, A, lda, Bm, ldb, bias, C, N);
  return cudaGetLastError();
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum over blockDim.x (a multiple of 32, <= 1024); every thread
// gets the total. ``red`` is >= 32 floats of shared memory.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  int nw = blockDim.x >> 5;
  float t = lane < nw ? red[lane] : 0.0f;
  return warp_sum(t);
}

struct Tensors8 {
  float* p[8];
  int n[8];
};

struct RegTable {
  float L1[8], L2[8];
};

// L1/L2 weight cost of the pre-update parameters: one block.
__global__ void k_wcost(Tensors8 t, RegTable r, float* __restrict__ out) {
  __shared__ float red[32];
  float total = 0.0f;
  for (int k = 0; k < 8; ++k) {
    if (r.L1[k] == 0.0f && r.L2[k] == 0.0f) continue;
    float s1 = 0.0f, s2 = 0.0f;
    for (int i = threadIdx.x; i < t.n[k]; i += blockDim.x) {
      float v = t.p[k][i];
      s1 += fabsf(v);
      s2 += v * v;
    }
    s1 = block_sum(s1, red);
    s2 = block_sum(s2, red);
    total += r.L1[k] * s1 + r.L2[k] * s2;
  }
  if (threadIdx.x == 0) out[0] = total;
}

// The dense tail's head and everything that needs a batch-wide view, in
// one block: dropout mask, scores, log-softmax NLL, (cost, minf), dL/dz4,
// dwo, dbo, dz3 = (dz4 wo^T) * mask * act_h'(z3), dbh.
__global__ void k_head(Dims d, const float* __restrict__ z3,
                       const float* __restrict__ wo,
                       const float* __restrict__ bo, const int* __restrict__ db,
                       const int* __restrict__ y, const float* __restrict__ wcost,
                       float* __restrict__ h3d, float* __restrict__ dz3,
                       float* __restrict__ gwo, float* __restrict__ gbo,
                       float* __restrict__ gbh, float* __restrict__ cm) {
  extern __shared__ float sm[];
  const int B = d.B, NH = d.NH, NC = d.NC;
  float* z4 = sm;              // B*NC scores, then log-probs
  float* dz4 = sm + B * NC;    // B*NC
  float* tl = sm + 2 * B * NC; // B true-class log-probs
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int e = tid; e < B * NH; e += nt) {
    float h = act_fn(z3[e], d.acth, d.slopeh);
    if (d.pdrop > 0.0f && !(u01(db[e]) >= d.pdrop)) h = 0.0f * h;
    h3d[e] = h;
  }
  __syncthreads();
  const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  for (int o = wid; o < B * NC; o += nw) {
    int b = o / NC, c = o % NC;
    float s = 0.0f;
    for (int n = lane; n < NH; n += 32) s += h3d[b * NH + n] * wo[n * NC + c];
    s = warp_sum(s);
    if (lane == 0) z4[o] = s + bo[c];
  }
  __syncthreads();
  const float invB = 1.0f / (float)B;
  for (int b = tid; b < B; b += nt) {
    float mx = -INFINITY;
    for (int c = 0; c < NC; ++c) mx = fmaxf(mx, z4[b * NC + c]);
    float se = 0.0f;
    for (int c = 0; c < NC; ++c) se += expf(z4[b * NC + c] - mx);
    float lse = logf(se);
    int yb = y[b];
    float t = NAN;  // a label outside [0, NC) poisons the cost
    for (int c = 0; c < NC; ++c) {
      float lp = (z4[b * NC + c] - mx) - lse;
      z4[b * NC + c] = lp;
      if (c == yb) t = lp;
      dz4[b * NC + c] = (expf(lp) - (c == yb ? 1.0f : 0.0f)) * invB;
    }
    tl[b] = t;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f, mn = INFINITY;
    for (int b = 0; b < B; ++b) {
      s += tl[b];
      mn = fminf(mn, tl[b]);
    }
    cm[0] = -s / (float)B + (wcost ? wcost[0] : 0.0f);
    cm[1] = mn;
  }
  for (int e = tid; e < NH * NC; e += nt) {
    int n = e / NC, c = e % NC;
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += h3d[b * NH + n] * dz4[b * NC + c];
    gwo[e] = s;
  }
  for (int c = tid; c < NC; c += nt) {
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += dz4[b * NC + c];
    gbo[c] = s;
  }
  for (int e = tid; e < B * NH; e += nt) {
    int b = e / NH, n = e % NH;
    float s = 0.0f;
    for (int c = 0; c < NC; ++c) s += dz4[b * NC + c] * wo[n * NC + c];
    if (d.pdrop > 0.0f && !(u01(db[e]) >= d.pdrop)) s = 0.0f * s;
    dz3[e] = s * dact_fn(z3[e], d.acth, d.slopeh);
  }
  __syncthreads();
  for (int n = tid; n < NH; n += nt) {
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += dz3[b * NH + n];
    gbh[n] = s;
  }
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

// Weight gradient of a true valid convolution, in kernel layout:
// dw[m, (u*F+v)*Cin + c] = sum_{b,y,x<e} dz[b,m,y,x] * in[b,c,y+F-1-u,x+F-1-v],
// and (blockIdx.y == F*F*Cin) the bias gradient sum_{b,y,x} dz[b,m,y,x].
// One block per output. ``in`` is addressed as b*sb + c*sc + yy*W + xx.
__global__ void k_conv_wgrad(int B, int M, int Cin, int F, int cs, int e,
                             const float* __restrict__ dz,
                             const float* __restrict__ in, int sb, int sc,
                             int W, float* __restrict__ dw,
                             float* __restrict__ dbias) {
  __shared__ float red[32];
  const int m = blockIdx.x, o = blockIdx.y;
  const bool bias = o == F * F * Cin;
  int u = 0, v = 0, c = 0;
  if (!bias) {
    c = o % Cin;
    u = (o / Cin) / F;
    v = (o / Cin) % F;
  }
  float s = 0.0f;
  for (int t = threadIdx.x; t < B * e * e; t += blockDim.x) {
    int b = t / (e * e), y = (t / e) % e, x = t % e;
    float g = dz[((b * M + m) * cs + y) * cs + x];
    s += bias ? g
              : g * in[b * sb + c * sc + (y + F - 1 - u) * W + (x + F - 1 - v)];
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) {
    if (bias) dbias[m] = s;
    else dw[m * F * F * Cin + o] = s;
  }
}

// conv2 input gradient + pool1 backward + act1': one thread per pooled1
// position; writes dz1 for the members of its window.
__global__ void k_conv2_dgrad_pool1_bwd(Dims d, const float* __restrict__ w2,
                                        const float* __restrict__ dz2,
                                        const float* __restrict__ z1,
                                        const float* __restrict__ p1,
                                        float* __restrict__ dz1) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= d.B * d.M1 * d.P1 * d.P1) return;
  const int F = d.F2, M1 = d.M1;
  int j = idx % d.P1, i = (idx / d.P1) % d.P1;
  int m1 = (idx / (d.P1 * d.P1)) % M1, b = idx / (d.P1 * d.P1 * M1);
  float dp = 0.0f;
  for (int m2 = 0; m2 < d.M2; ++m2)
    for (int u = 0; u < F; ++u) {
      int y = i - (F - 1 - u);
      if (y < 0 || y >= d.e2) continue;
      for (int v = 0; v < F; ++v) {
        int x = j - (F - 1 - v);
        if (x < 0 || x >= d.e2) continue;
        dp += w2[m2 * F * F * M1 + (u * F + v) * M1 + m1]
              * dz2[((b * d.M2 + m2) * d.c2 + y) * d.c2 + x];
      }
    }
  float mx = p1[idx];
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

struct UpdateTable {
  float* p[8];
  float* a[8];
  const float* g[8];
  int off[9];  // prefix offsets of the 8 tensors in one flat index space
  float L1[8], L2x2[8], mom[8], omm[8], rate[8], clip[8];
};

// L1/L2 gradient + old-accumulator momentum step, all 8 tensors in one
// launch; bias max-norm (a clip) is elementwise and happens here too.
__global__ void k_update(UpdateTable t, float lr) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= t.off[8]) return;
  int k = 0;
  while (i >= t.off[k + 1]) ++k;
  if (t.rate[k] == 0.0f) return;
  int j = i - t.off[k];
  float p = t.p[k][j], a = t.a[k][j], g = t.g[k][j];
  if (t.L2x2[k] != 0.0f) g = g + t.L2x2[k] * p;
  if (t.L1[k] != 0.0f) g = g + t.L1[k] * (float)((p > 0.0f) - (p < 0.0f));
  float pn = p - (t.rate[k] * lr) * a;
  if (t.clip[k] > 0.0f) pn = fminf(fmaxf(pn, -t.clip[k]), t.clip[k]);
  t.a[k][j] = t.mom[k] * a + t.omm[k] * g;
  t.p[k][j] = pn;
}

__device__ __forceinline__ float maxnorm_scale(float norm, float maxnorm) {
  float desired = fminf(fmaxf(norm, 0.0f), maxnorm);
  return (1e-7f + desired) / (1e-7f + norm);
}

// Max-norm over rows (conv kernels in kernel layout): one block per row.
__global__ void k_maxnorm_rows(float* __restrict__ p, int cols,
                               float maxnorm) {
  __shared__ float red[32];
  float* row = p + (size_t)blockIdx.x * cols;
  float s = 0.0f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) s += row[c] * row[c];
  float scale = maxnorm_scale(sqrtf(block_sum(s, red)), maxnorm);
  for (int c = threadIdx.x; c < cols; c += blockDim.x) row[c] *= scale;
}

// Max-norm over columns (dense weights): one thread per column.
__global__ void k_maxnorm_cols(float* __restrict__ p, int rows, int cols,
                               float maxnorm) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.0f;
  for (int r = 0; r < rows; ++r) s += p[(size_t)r * cols + c] * p[(size_t)r * cols + c];
  float scale = maxnorm_scale(sqrtf(s), maxnorm);
  for (int r = 0; r < rows; ++r) p[(size_t)r * cols + c] *= scale;
}

struct Workspace {
  float *tyx, *a, *z1, *p1, *z2, *f, *z3, *h3d, *dz3, *df, *dz2, *dz1,
      *grads, *wcost;
  long long total;
};

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
  w.total = o;
  return w;
}

inline int blocks(long long n, int t) { return (int)((n + t - 1) / t); }

}  // namespace

#define CHECK(expr)                  \
  do {                               \
    cudaError_t e_ = (expr);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)
#define LAUNCHED() CHECK(cudaGetLastError())

extern "C" {

// Floats of scratch the wrapper must allocate for one epoch call.
long long megastep_workspace_floats(const int* ispec, const float* fspec) {
  return carve(make_dims(ispec, fspec), nullptr).total;
}

const char* megastep_error_string(int code) {
  if (code == -1) return "warp field needs more shared memory than a block has";
  if (code == -2) return "batch x classes too large for the head kernel's shared memory";
  return cudaGetErrorString((cudaError_t)code);
}

// One epoch: n_steps steps on ``stream`` of ``device``; parameters and momentum in the
// pointer table are updated in place, cost_minf (n_steps, 2) is written.
// Returns 0, or the first CUDA error (the launch that failed never ran).
int megastep_epoch(const int* is, const float* fs, void* const* ptrs,
                   int n_steps, float lr, float* ws, int device,
                   void* stream_) {
  CHECK(cudaSetDevice(device));
  cudaStream_t s = (cudaStream_t)stream_;
  const Dims d = make_dims(is, fs);
  const Workspace w = carve(d, ws);
  const float* x = (const float*)ptrs[P_X];
  const int* y = (const int*)ptrs[P_Y];
  const int* ub = (const int*)ptrs[P_UB];
  const int* fb = (const int*)ptrs[P_FB];
  const int* pb = (const int*)ptrs[P_PB];
  const int* db = (const int*)ptrs[P_DB];
  const float* gh = (const float*)ptrs[P_GH];
  const float* gw = (const float*)ptrs[P_GW];
  float* prm[8];
  float* mom[8];
  for (int k = 0; k < 8; ++k) {
    prm[k] = (float*)ptrs[P_PARAMS + k];
    mom[k] = (float*)ptrs[P_MOMS + k];
  }
  float* cm = (float*)ptrs[P_CM];

  const int sizes[8] = {d.M1 * d.F1 * d.F1 * d.C0, d.M1,
                        d.M2 * d.F2 * d.F2 * d.M1, d.M2,
                        d.NF * d.NH, d.NH, d.NH * d.NC, d.NC};
  float* grad[8];
  {
    float* g = w.grads;
    for (int k = 0; k < 8; ++k) { grad[k] = g; g += sizes[k]; }
  }

  WarpParams wp;
  wp.trans = is[I_TRANS]; wp.mag = is[I_MAG]; wp.zoom = is[I_ZOOM];
  wp.angle = is[I_ANGLE];
  wp.translation = fs[F_TRANS]; wp.logzoom = fs[F_LOGZOOM];
  wp.magnitude = fs[F_MAG]; wp.angle_rad = fs[F_ANGLE];
  wp.clip_hi = fs[F_CLIPHI];
  const int warp = wp.trans || wp.mag || wp.zoom || wp.angle;
  const float pflip = is[I_PFLIP] ? fs[F_PFLIP] : 0.0f;

  const size_t warp_smem = 4 * sizeof(float) * (size_t)d.HW;
  if (warp && warp_smem > 48 * 1024) {
    if (warp_smem > 227 * 1024) return -1;
    CHECK(cudaFuncSetAttribute(k_warp,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)warp_smem));
  }
  const size_t head_smem = sizeof(float) * (size_t)(2 * d.B * d.NC + d.B);
  if (head_smem > 48 * 1024) return -2;

  const float* reg = fs + F_REG0;  // conv1, conv2, hidden, out
  Tensors8 t8;
  RegTable rt;
  UpdateTable ut;
  bool any_wcost = false;
  ut.off[0] = 0;
  for (int k = 0; k < 8; ++k) {
    const float* r = reg + (k / 2) * N_REG;
    t8.p[k] = prm[k];
    t8.n[k] = sizes[k];
    rt.L1[k] = r[R_L1];
    rt.L2[k] = r[R_L2];
    any_wcost = any_wcost || r[R_L1] != 0.0f || r[R_L2] != 0.0f;
    ut.p[k] = prm[k];
    ut.a[k] = mom[k];
    ut.g[k] = grad[k];
    ut.off[k + 1] = ut.off[k] + sizes[k];
    ut.L1[k] = r[R_L1];
    ut.L2x2[k] = r[R_L2X2];
    ut.mom[k] = r[R_MOM];
    ut.omm[k] = r[R_OMM];
    ut.rate[k] = r[R_RATE];
    ut.clip[k] = (k % 2 == 1) ? r[R_MAXNORM] : 0.0f;  // biases clip
  }

  const int T = 256;
  for (int st = 0; st < n_steps; ++st) {
    const float* xs = x + (size_t)st * d.C0 * d.B * d.HW;
    const int* ys = y + (size_t)st * d.B;
    const int* pbs = pb + (size_t)st * d.C0 * d.B * d.HW;
    const int* dbs = db + (size_t)st * d.B * d.NH;
    if (warp) {
      k_warp<<<1, 256, warp_smem, s>>>(d, wp, ub + (size_t)st * 8,
                                        fb + (size_t)st * 4 * d.HW, gh, gw,
                                        w.tyx);
      LAUNCHED();
    }
    k_augment<<<blocks((long long)d.C0 * d.B * d.HW, T), T, 0, s>>>(
        d, warp, is[I_NEAREST], is[I_INVERT], pflip, xs, w.tyx, pbs, w.a);
    LAUNCHED();
    k_conv1_pool<<<blocks((long long)d.B * d.M1 * d.P1 * d.P1, T), T, 0, s>>>(
        d, w.a, prm[0], prm[1], w.z1, w.p1);
    LAUNCHED();
    k_conv2_pool<<<blocks((long long)d.B * d.M2 * d.P2 * d.P2, T), T, 0, s>>>(
        d, w.p1, prm[2], prm[3], w.z2, w.f);
    LAUNCHED();
    CHECK((gemm<false, false>(s, d.B, d.NH, d.NF, w.f, d.NF, prm[4], d.NH,
                              prm[5], w.z3)));
    if (any_wcost) {
      k_wcost<<<1, 1024, 0, s>>>(t8, rt, w.wcost);
      LAUNCHED();
    }
    k_head<<<1, 1024, head_smem, s>>>(d, w.z3, prm[6], prm[7], dbs, ys,
                                       any_wcost ? w.wcost : nullptr, w.h3d,
                                       w.dz3, grad[6], grad[7], grad[5],
                                       cm + 2 * (size_t)st);
    LAUNCHED();
    // dwh = f^T dz3 ; df = dz3 wh^T
    CHECK((gemm<true, false>(s, d.NF, d.NH, d.B, w.f, d.NF, w.dz3, d.NH,
                             nullptr, grad[4])));
    CHECK((gemm<false, true>(s, d.B, d.NF, d.NH, w.dz3, d.NH, prm[4], d.NH,
                             nullptr, w.df)));
    k_pool2_bwd<<<blocks((long long)d.B * d.M2 * d.c2 * d.c2, T), T, 0, s>>>(
        d, w.z2, w.f, w.df, w.dz2);
    LAUNCHED();
    k_conv_wgrad<<<dim3(d.M2, d.F2 * d.F2 * d.M1 + 1), T, 0, s>>>(
        d.B, d.M2, d.M1, d.F2, d.c2, d.e2, w.dz2, w.p1, d.M1 * d.P1 * d.P1,
        d.P1 * d.P1, d.P1, grad[2], grad[3]);
    LAUNCHED();
    k_conv2_dgrad_pool1_bwd<<<blocks((long long)d.B * d.M1 * d.P1 * d.P1, T),
                              T, 0, s>>>(d, prm[2], w.dz2, w.z1, w.p1, w.dz1);
    LAUNCHED();
    k_conv_wgrad<<<dim3(d.M1, d.F1 * d.F1 * d.C0 + 1), T, 0, s>>>(
        d.B, d.M1, d.C0, d.F1, d.c1, d.e1, w.dz1, w.a, d.HW, d.B * d.HW, d.H,
        grad[0], grad[1]);
    LAUNCHED();
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
  }
  return 0;
}

}  // extern "C"

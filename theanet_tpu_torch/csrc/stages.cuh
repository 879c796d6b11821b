// Stage kernels shared by the fused-epoch kernels (megastep.cu,
// megastep_deep.cu), each compiled into its own library: the injected-bit
// uniforms, the activation registry, the step's warp field, a tiled GEMM,
// block reductions, the conv weight gradient, the weight cost and the
// old-accumulator momentum update with max-norm. Every function here
// follows a line of the plain PyTorch twins in theanet_tpu_torch/ops/.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CHECK(expr)                        \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)
#define LAUNCHED() CHECK(cudaGetLastError())

namespace {

constexpr int MASK24 = 0xFFFFFF;
constexpr float INV24 = 1.0f / 16777216.0f;
constexpr float TWO_PI = 6.28318530717958647692f;
constexpr int ACT_LEAKY = 0, ACT_TANH = 1, ACT_STANH = 2, ACT_SIGMOID = 3,
              ACT_SOFTPLUS = 4;
// per-layer regularization values, in the order ops/_build.py packs them
enum { R_L1, R_L2X2, R_L2, R_MOM, R_OMM, R_RATE, R_MAXNORM, N_REG };

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

// The step's shared warp target (ty, tx) -> tyx[0:HW], tyx[HW:2HW] of an
// H x H image. One block; dynamic shared memory holds the two noise fields
// and their half-smoothed products (4*HW floats). Every product and sum is
// rounded on its own (__fmul_rn, __fadd_rn: no fused multiply-adds), the
// smoothing sums run k = 0, 1, ..., as in the twin (ops/megastep.py
// warp_field): the warp then matches the twin's to the bit, and with it
// the resampled pixels and which pool windows tie.
__global__ void k_warp(int H, WarpParams w, const int* __restrict__ ub,
                       const int* __restrict__ fb, const float* __restrict__ gh,
                       const float* __restrict__ gw, float* __restrict__ tyx) {
  extern __shared__ float sm[];
  const int HW = H * H;
  float* n0 = sm;
  float* n1 = sm + HW;
  float* t0 = sm + 2 * HW;
  float* t1 = sm + 3 * HW;
  float u[8];
  for (int j = 0; j < 8; ++j)
    u[j] = __fsub_rn(__fmul_rn(2.0f, u01(ub[j])), 1.0f);

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
        a0 = __fadd_rn(a0, __fmul_rn(g, n0[k * H + j]));
        a1 = __fadd_rn(a1, __fmul_rn(g, n1[k * H + j]));
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
        a0 = __fadd_rn(a0, __fmul_rn(t0[i * H + k], g));
        a1 = __fadd_rn(a1, __fmul_rn(t1[i * H + k], g));
      }
      n0[p] = a0;   // n0/n1 are no longer read: reuse them for S
      n1[p] = a1;
    }
    __syncthreads();
  }

  for (int p = threadIdx.x; p < HW; p += blockDim.x) {
    float ty = (float)(p / H), tx = (float)(p % H);
    if (w.trans) {
      ty = __fadd_rn(ty, __fmul_rn(w.translation, u[0]));
      tx = __fadd_rn(tx, __fmul_rn(w.translation, u[1]));
    }
    if (w.mag) {
      ty = __fadd_rn(ty, n0[p]);
      tx = __fadd_rn(tx, n1[p]);
    }
    if (w.zoom || w.angle) {
      float oy = __fmul_rn(__fadd_rn(0.5f, __fmul_rn(0.25f, u[2])), (float)H);
      float ox = __fmul_rn(__fadd_rn(0.5f, __fmul_rn(0.25f, u[3])), (float)H);
      ty = __fsub_rn(ty, oy);
      tx = __fsub_rn(tx, ox);
      if (w.zoom) {
        ty = __fmul_rn(ty, expf(__fmul_rn(w.logzoom, u[4])));
        tx = __fmul_rn(tx, expf(__fmul_rn(w.logzoom, u[5])));
      }
      if (w.angle) {
        float th = __fmul_rn(w.angle_rad, u[6]);
        float ct = cosf(th), st = sinf(th);
        float ny = __fadd_rn(__fmul_rn(ct, ty), __fmul_rn(st, tx));
        float nx = __fadd_rn(__fmul_rn(-st, ty), __fmul_rn(ct, tx));
        ty = ny;
        tx = nx;
      }
      ty = __fadd_rn(ty, oy);
      tx = __fadd_rn(tx, ox);
    }
    tyx[p] = fminf(fmaxf(ty, 0.0f), w.clip_hi);
    tyx[HW + p] = fminf(fmaxf(tx, 0.0f), w.clip_hi);
  }
}

// The most dynamic shared memory a block can opt in to on sm_90.
constexpr size_t SMEM_OPT_IN = 227 * 1024;

// ``bytes`` of dynamic shared memory for ``kernel``, raising the block's
// limit above the 48 KB default where needed (up to SMEM_OPT_IN); false
// when no block can hold it.
template <typename Kernel>
inline bool smem_opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return true;
  if (bytes > SMEM_OPT_IN) return false;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes) == cudaSuccess;
}

// Dynamic shared memory of k_warp, opting in where the image needs it.
inline bool warp_smem_ok(size_t bytes) { return smem_opt_in(k_warp, bytes); }

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

// Weight gradient of a true convolution, in kernel layout:
// dw[m, (u*F+v)*Cin + c] = sum_{b,y,x<e} dz[b,m,y,x] * in[b,c,iy,ix] with
// iy = y*cstride + F-1-u - pad (ix likewise; zero off the W x W input),
// and (blockIdx.y == F*F*Cin) the bias gradient sum_{b,y,x} dz[b,m,y,x].
// cstride 1 and pad 0 are the valid conv. One block per output. ``in`` is
// addressed as b*sb + c*sc + iy*W + ix.
__global__ void k_conv_wgrad(int B, int M, int Cin, int F, int cs, int e,
                             const float* __restrict__ dz,
                             const float* __restrict__ in, int sb, int sc,
                             int W, float* __restrict__ dw,
                             float* __restrict__ dbias, int cstride,
                             int pad) {
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
  if (cstride == 1 && pad == 0) {   // valid: every tap reads the input
    for (int t = threadIdx.x; t < B * e * e; t += blockDim.x) {
      int b = t / (e * e), y = (t / e) % e, x = t % e;
      float g = dz[((b * M + m) * cs + y) * cs + x];
      s += bias ? g
                : g * in[b * sb + c * sc + (y + F - 1 - u) * W
                         + (x + F - 1 - v)];
    }
  } else {
    for (int t = threadIdx.x; t < B * e * e; t += blockDim.x) {
      int b = t / (e * e), y = (t / e) % e, x = t % e;
      float g = dz[((b * M + m) * cs + y) * cs + x];
      int iy = y * cstride + F - 1 - u - pad;
      int ix = x * cstride + F - 1 - v - pad;
      float xv = (iy >= 0 && iy < W && ix >= 0 && ix < W)
                     ? in[b * sb + c * sc + iy * W + ix] : 0.0f;
      s += bias ? g : g * xv;
    }
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) {
    if (bias) dbias[m] = s;
    else dw[m * F * F * Cin + o] = s;
  }
}

// Room for every state tensor of a fused net: 2 per conv level, 2 per
// dense layer and the learned centers.
constexpr int MAX_TENSORS = 40;

struct WcostTable {
  int count;
  const float* p[MAX_TENSORS];
  int n[MAX_TENSORS];
  float L1[MAX_TENSORS], L2[MAX_TENSORS];
};

// L1/L2 weight cost of the pre-update parameters, in two passes so that
// every SM streams a slice of the weights: WCOST_BLOCKS blocks each write
// the partial sum of their grid-strided elements of every charged tensor,
// then one block adds the partials in a fixed order (no atomics: the cost
// is the same on every run). ``part`` holds WCOST_BLOCKS floats.
constexpr int WCOST_BLOCKS = 128, WCOST_THREADS = 256;

__global__ void k_wcost_part(WcostTable t, float* __restrict__ part) {
  __shared__ float red[32];
  float total = 0.0f;
  const int stride = gridDim.x * blockDim.x;
  for (int k = 0; k < t.count; ++k) {
    if (t.L1[k] == 0.0f && t.L2[k] == 0.0f) continue;
    float s1 = 0.0f, s2 = 0.0f;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < t.n[k];
         i += stride) {
      float v = t.p[k][i];
      s1 += fabsf(v);
      s2 += v * v;
    }
    total += t.L1[k] * s1 + t.L2[k] * s2;
  }
  total = block_sum(total, red);
  if (threadIdx.x == 0) part[blockIdx.x] = total;
}

__global__ void k_wcost_sum(const float* __restrict__ part, int n,
                            float* __restrict__ out) {
  __shared__ float red[32];
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += part[i];
  s = block_sum(s, red);
  if (threadIdx.x == 0) out[0] = s;
}

inline cudaError_t wcost(cudaStream_t s, const WcostTable& t, float* part,
                         float* out) {
  k_wcost_part<<<WCOST_BLOCKS, WCOST_THREADS, 0, s>>>(t, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k_wcost_sum<<<1, WCOST_BLOCKS, 0, s>>>(part, WCOST_BLOCKS, out);
  return cudaGetLastError();
}

struct UpdateTable {
  int count;
  float* p[MAX_TENSORS];
  float* a[MAX_TENSORS];
  const float* g[MAX_TENSORS];
  int off[MAX_TENSORS + 1];  // prefix offsets in one flat index space
  float L1[MAX_TENSORS], L2x2[MAX_TENSORS], mom[MAX_TENSORS],
      omm[MAX_TENSORS], rate[MAX_TENSORS], clip[MAX_TENSORS];
};

// L1/L2 gradient + old-accumulator momentum step of every state tensor in
// one launch; bias max-norm (a clip) is elementwise and happens here too.
__global__ void k_update(UpdateTable t, float lr) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= t.off[t.count]) return;
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

inline int blocks(long long n, int t) { return (int)((n + t - 1) / t); }

}  // namespace

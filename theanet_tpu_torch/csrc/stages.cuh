// Stage kernels shared by the fused-epoch kernels (megastep.cu,
// megastep_deep.cu), each compiled into its own library: the injected-bit
// uniforms, the activation registry, the step's warp field, the heads'
// 16x16 tile, block reductions and fixed-order column sums, programmatic
// dependent launch, the dense products at a small batch (split-K tiles),
// the conv weight gradient (batch slices) and the conv input gradient's
// staging, the weight cost and the old-accumulator momentum update with
// max-norm. Every launch plan here depends on the shapes alone, and every
// cross-block sum runs in that plan's fixed order (no atomics).
// ops/stage_plan.py mirrors the plans; every function here follows a line
// of the plain PyTorch twins in theanet_tpu_torch/ops/.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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

// The product element (m0 + threadIdx.y, n0 + threadIdx.x) of one 16x16
// output tile of A(M,K) @ B(K,N), A(m,k) = TA ? A[k*lda+m] : A[m*lda+k],
// B(k,n) = TB ? B[n*ldb+k] : B[k*ldb+n], summed over k in [kb, ke) in order,
// 16 k a shared-memory round (loads coalesced along the stored rows in every
// transpose case). Every thread of the TILE x TILE block calls it: it
// synchronises the block. The heads' stages (k_head_*) run on it; the
// products of the dense tails run on gemm below.
constexpr int TILE = 16;

template <bool TA, bool TB>
__device__ __forceinline__ float gemm_tile(int M, int N, int kb, int ke,
                                           const float* __restrict__ A,
                                           int lda,
                                           const float* __restrict__ Bm,
                                           int ldb, int m0, int n0) {
  __shared__ float As[TILE][TILE + 1];  // As[m][k]
  __shared__ float Bs[TILE][TILE + 1];  // Bs[k][n]
  const int tx = threadIdx.x, ty = threadIdx.y;
  float acc = 0.0f;
  for (int k0 = kb; k0 < ke; k0 += TILE) {
    if (TA) {
      int m = m0 + tx, k = k0 + ty;
      As[tx][ty] = (m < M && k < ke) ? A[(size_t)k * lda + m] : 0.0f;
    } else {
      int m = m0 + ty, k = k0 + tx;
      As[ty][tx] = (m < M && k < ke) ? A[(size_t)m * lda + k] : 0.0f;
    }
    if (TB) {
      int n = n0 + ty, k = k0 + tx;
      Bs[tx][ty] = (n < N && k < ke) ? Bm[(size_t)n * ldb + k] : 0.0f;
    } else {
      int k = k0 + ty, n = n0 + tx;
      Bs[ty][tx] = (n < N && k < ke) ? Bm[(size_t)k * ldb + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE; ++kk) acc += As[ty][kk] * Bs[kk][tx];
    __syncthreads();
  }
  return acc;
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

// block_sum's form for the largest (or, ``MIN``, the smallest) value, by
// fmaxf / fminf: a NaN is passed over, as in a serial fmaxf loop.
template <bool MIN>
__device__ float block_extreme(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MIN ? fminf(v, u) : fmaxf(v, u);
  }
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  int nw = blockDim.x >> 5;
  float t = lane < nw ? red[lane] : (MIN ? INFINITY : -INFINITY);
  for (int o = 16; o > 0; o >>= 1) {
    float u = __shfl_xor_sync(0xffffffffu, t, o);
    t = MIN ? fminf(t, u) : fmaxf(t, u);
  }
  return t;
}

// Programmatic dependent launch (sm_90). A kernel started by launch_pdl may
// be scheduled while the kernel before it on the stream still runs, once
// that kernel has called pdl_trigger() (or ended): its launch latency then
// overlaps the other kernel's work. It calls pdl_wait() before it touches
// memory, which returns when the kernel before it has ended and its writes
// are visible; so the stream's order of effects is the plain launch's.
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// launch_pdl on a grid of clusters of ``cluster`` blocks along x (1: no
// clusters): a cluster's blocks run at once and share cluster_sync.
template <typename... KArgs, typename... Args>
cudaError_t launch_pdl(void (*kernel)(KArgs...), dim3 grid, dim3 block,
                       size_t smem, int cluster, cudaStream_t s,
                       Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

template <typename... KArgs, typename... Args>
cudaError_t launch_pdl(void (*kernel)(KArgs...), dim3 grid, dim3 block,
                       size_t smem, cudaStream_t s, Args... args) {
  return launch_pdl(kernel, grid, block, smem, 1, s, args...);
}

// launch_pdl with no dynamic shared memory.
template <typename... KArgs, typename... Args>
cudaError_t launch_pdl(void (*kernel)(KArgs...), dim3 grid, dim3 block,
                       cudaStream_t s, Args... args) {
  return launch_pdl(kernel, grid, block, (size_t)0, s, args...);
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Loads a thread issues before it waits on any of them, where a stage
// reads a run of independent values (sum_slices).
constexpr int STAGE_BATCH = 8;

inline int blocks(long long n, int t) { return (int)((n + t - 1) / t); }

// ---- the launch plans of the gradient and product stages. Each depends on
// the shapes alone (never on the data or on the card found at run time), so
// every sum below runs in one order on every run and every rank;
// theanet_tpu_torch/ops/stage_plan.py mirrors them line for line.
constexpr int SM_COUNT = 132;              // the H100 SXM's SMs
constexpr int STAGE_FLOATS = 12 * 1024;    // 48 KB: the default shared limit
constexpr int ERR_STAGE_SMEM = -5;         // a stage's staging exceeds 227 KB
const char* const stage_smem_error =
    "a conv level's gradient stage needs more shared memory than a block has";

// Dense products C = A B at a small batch: M = B rows (1 to 20 on the main
// path, 3000 in the long-batch runs) against K of hundreds. One 16 x 16
// tile a block takes GK of K a shared-memory round; when the tiles are too
// few to fill the card, K is cut into ``nks`` slices of ``kslice`` (whole
// rounds), one block a (tile, slice), each writing its partial tile, and
// the tile's last block to finish adds the slices in slice order
// (last_block). The bias, and for a hidden layer the activation and the
// dropout mask, ride in the block that writes C (GemmEpi). At most
// GEMM_PART_CAP partial floats: the workspace region.
constexpr int GK = 64;
constexpr int GEMM_KMIN = 128;             // the shortest slice of K
constexpr int GEMM_TARGET = 1024;          // blocks wanted: ~8 an SM
constexpr long long GEMM_PART_CAP = 1LL << 18;

struct GemmPlan {
  int nks, kslice;
  long long part_floats;
};

inline GemmPlan gemm_plan(int M, int N, int K) {
  const int tiles = cdiv(M, TILE) * cdiv(N, TILE);
  int nks = std::min(cdiv(K, GEMM_KMIN),
                     std::max(1, cdiv(GEMM_TARGET, tiles)));
  nks = (int)std::min<long long>(
      nks, std::max(1LL, GEMM_PART_CAP / ((long long)M * N)));
  GemmPlan p;
  p.kslice = cdiv(cdiv(K, nks), GK) * GK;
  p.nks = cdiv(K, p.kslice);
  p.part_floats = p.nks > 1 ? (long long)p.nks * M * N : 0;
  return p;
}

// Where a product's rows land: C (leading dimension ldc) = A B + bias;
// with ``h``, also h = act(C) and, where the unit's dropout word
// u01(db[m*dbl + off + n]) is below pdrop, h = 0 * h (a NaN or inf still
// propagates; no rescale).
struct GemmEpi {
  const float* bias;
  float* C;
  int ldc;
  float* h;
  int act;
  float slope, pdrop;
  const int* db;
  int dbl, off;
};

inline GemmEpi gemm_out(float* C, int ldc, const float* bias = nullptr) {
  GemmEpi e = {};
  e.bias = bias;
  e.C = C;
  e.ldc = ldc;
  return e;
}

// A hidden layer's product through its epilogue: z = f W + b to ``z``,
// then hd = act(z) with the dropout mask of lanes [off, off + width) of the
// step's dropout words (GemmEpi) to ``hd``.
inline GemmEpi hidden_out(float* z, int width, const float* bias, float* hd,
                          int act, float slope, float pdrop, const int* db,
                          int dbl, int off) {
  GemmEpi e = gemm_out(z, width, bias);
  e.h = hd;
  e.act = act;
  e.slope = slope;
  e.pdrop = pdrop;
  e.db = db;
  e.dbl = dbl;
  e.off = off;
  return e;
}

__device__ __forceinline__ void gemm_store(const GemmEpi& ep, int m, int n,
                                           float acc) {
  const float z = ep.bias ? acc + ep.bias[n] : acc;
  const size_t e = (size_t)m * ep.ldc + n;
  ep.C[e] = z;
  if (ep.h) {
    float h = act_fn(z, ep.act, ep.slope);
    if (ep.pdrop > 0.0f
        && !(u01(ep.db[(size_t)m * ep.dbl + ep.off + n]) >= ep.pdrop))
      h = 0.0f * h;
    ep.h[e] = h;
  }
}

// gemm_tile's element over k in [kb, ke), GK of k a shared-memory round:
// the block loads a 16 x GK slab of A and a GK x 16 slab of B (eight loads
// a thread, issued together), then each thread adds the round's products
// in k order. (On the H100 at the small-batch shapes this tile, with K
// cut into slices of 128, ran faster than a 32 x 32 tile of four outputs
// a thread and than an in-block split of K.)
template <bool TA, bool TB>
__device__ __forceinline__ float gemm_tile_gk(int M, int N, int kb, int ke,
                                              const float* __restrict__ A,
                                              int lda,
                                              const float* __restrict__ Bm,
                                              int ldb, int m0, int n0) {
  __shared__ float As[TILE][GK + 1];   // As[m][k]
  __shared__ float Bs[GK][TILE + 1];   // Bs[k][n]
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * TILE + tx;
  const int ta = t % TILE, tb = t / TILE;   // along the stored rows / across
  float acc = 0.0f;
  for (int k0 = kb; k0 < ke; k0 += GK) {
#pragma unroll
    for (int j = 0; j < GK / TILE; ++j) {
      if (TA) {   // A stored (K, M): rows of k, m along them
        const int m = m0 + ta, kk = tb + TILE * j, k = k0 + kk;
        As[ta][kk] = (m < M && k < ke) ? A[(size_t)k * lda + m] : 0.0f;
      } else {
        const int m = m0 + tb, kk = ta + TILE * j, k = k0 + kk;
        As[tb][kk] = (m < M && k < ke) ? A[(size_t)m * lda + k] : 0.0f;
      }
      if (TB) {   // B stored (N, K)
        const int n = n0 + tb, kk = ta + TILE * j, k = k0 + kk;
        Bs[kk][tb] = (n < N && k < ke) ? Bm[(size_t)n * ldb + k] : 0.0f;
      } else {
        const int n = n0 + ta, kk = tb + TILE * j, k = k0 + kk;
        Bs[kk][ta] = (n < N && k < ke) ? Bm[(size_t)k * ldb + n] : 0.0f;
      }
    }
    __syncthreads();
    if (ke - k0 >= GK) {   // a whole round unrolled: its loads pipelined
#pragma unroll
      for (int kk = 0; kk < GK; ++kk) acc += As[ty][kk] * Bs[kk][tx];
    } else {
      for (int kk = 0; kk < ke - k0; ++kk) acc += As[ty][kk] * Bs[kk][tx];
    }
    __syncthreads();
  }
  return acc;
}

// The last of ``n`` blocks to reach this point for counter ``ctr`` (an
// integer count, an order-free event: every sum stays in its fixed order)
// returns true, and then sees the others' global writes; the counter is
// back at 0 when it returns. Each block calls it once, with the whole
// block, after its writes. The barrier orders the block's writes before
// its first thread's atomic, whose release (acq_rel, gpu scope) publishes
// them and whose acquire in the last block, then that block's barrier,
// makes every block's visible to its threads (read them with __ldcg).
__device__ __forceinline__ bool last_block(unsigned* ctr, unsigned n) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], 1;"
                 : "=r"(prev) : "l"(ctr) : "memory");
    last = prev == n - 1;
    if (last) *ctr = 0u;   // every block of this launch has counted
  }
  __syncthreads();
  return last;
}

// p[0] + p[stride] + ... in order from 0.0f, read through L2 (the writes of
// other blocks of this launch), NB loads in flight.
template <int NB = STAGE_BATCH>
__device__ __forceinline__ float sum_slices(const float* p, long long stride,
                                            int n) {
  float s = 0.0f;
  for (int k0 = 0; k0 < n; k0 += NB) {
    float v[NB];
#pragma unroll
    for (int r = 0; r < NB; ++r)
      v[r] = k0 + r < n ? __ldcg(p + (k0 + r) * stride) : 0.0f;
#pragma unroll
    for (int r = 0; r < NB; ++r)
      if (k0 + r < n) s += v[r];
  }
  return s;
}

// One (tile, K slice) a block (blockIdx.z the slice): the whole product
// through the epilogue when K is one slice; else the slice's partial tile
// to part[slice] (M, N), and the tile's last block to finish adds the
// slices in slice order and runs the epilogue (ctr: a zeroed counter a
// tile).
template <bool TA, bool TB>
__global__ void __launch_bounds__(TILE * TILE)
k_gemm_sk(int M, int N, int K, int kslice, const float* __restrict__ A,
          int lda, const float* __restrict__ Bm, int ldb, GemmEpi ep,
          float* __restrict__ part, unsigned* __restrict__ ctr) {
  pdl_wait();
  pdl_trigger();
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const int kb = blockIdx.z * kslice, ke = min(K, kb + kslice);
  const float acc = gemm_tile_gk<TA, TB>(M, N, kb, ke, A, lda, Bm, ldb, m0,
                                         n0);
  const int m = m0 + threadIdx.y, n = n0 + threadIdx.x;
  const bool in = m < M && n < N;
  if (gridDim.z == 1) {
    if (in) gemm_store(ep, m, n, acc);
    return;
  }
  const long long MN = (long long)M * N, e = (long long)m * N + n;
  if (in) part[blockIdx.z * MN + e] = acc;
  if (!last_block(ctr + blockIdx.y * gridDim.x + blockIdx.x, gridDim.z))
    return;
  if (in) gemm_store(ep, m, n, sum_slices(part + e, MN, gridDim.z));
}

// The stages' counters (last_block) start at 0 in every C entry call; each
// use leaves them at 0.
inline cudaError_t zero_counters(unsigned* ctr, long long n, cudaStream_t s) {
  return cudaMemsetAsync(ctr, 0, sizeof(unsigned) * n, s);
}

// C = A(M,K) B(K,N) through ``ep`` on gemm_plan's grid, started by
// programmatic dependent launch (its launch overlaps the stage before it;
// it waits for that stage's writes before it reads); ``part`` holds
// GEMM_PART_CAP floats, ``ctr`` GEMM_TARGET zeroed counters (a split
// product has fewer tiles).
template <bool TA, bool TB>
cudaError_t gemm(cudaStream_t s, int M, int N, int K, const float* A,
                 int lda, const float* Bm, int ldb, const GemmEpi& ep,
                 float* part, unsigned* ctr) {
  const GemmPlan p = gemm_plan(M, N, K);
  return launch_pdl(k_gemm_sk<TA, TB>,
                    dim3(cdiv(N, TILE), cdiv(M, TILE), p.nks),
                    dim3(TILE, TILE), s, M, N, K, p.kslice, A, lda, Bm, ldb,
                    ep, part, ctr);
}

constexpr int HEAD_T = 256;   // threads of a head block a sample

// Column sums of a row-major (R, N) matrix for the 32 columns [n0, n0 +
// 32) of one block of COLSUM_THREADS threads: row group g = threadIdx.x /
// 32 sums rows g, g + 8, ... in order, then group 0 adds the 8 groups in
// order. One fixed order for a given R (no atomics): the same sum on every
// run and every rank. Call with the whole block.
constexpr int COLSUM_THREADS = 256, COLSUM_GROUPS = COLSUM_THREADS / 32;

__device__ void block_colsum32(int R, int N, const float* __restrict__ x,
                               int n0, float* __restrict__ out) {
  __shared__ float part[COLSUM_GROUPS][33];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5, n = n0 + lane;
  float s = 0.0f;
  if (n < N)
    for (int r = g; r < R; r += COLSUM_GROUPS) s += x[(size_t)r * N + n];
  part[g][lane] = s;
  __syncthreads();
  if (g == 0 && n < N) {
    float t = part[0][lane];
    for (int k = 1; k < COLSUM_GROUPS; ++k) t += part[k][lane];
    out[n] = t;
  }
}

// A conv level's geometry for its gradient stages: conv output (y, x) of
// map m (B, M, c, c) reads input row y*cs + F-1-u - pad for tap u (zero off
// the W x W input); the pools' windows cover y, x < e. ``in`` (B, Cin, W, W)
// is addressed as b*sb + ci*sc + iy*W + ix.
struct ConvGeom {
  int B, M, Cin, F, c, e, cs, pad, W, sb, sc;
};

// ---- Weight gradient, in kernel layout: dw[m, (u*F+v)*Cin + ci] =
// sum_{b, y, x < e} dz[b,m,y,x] * in[b, ci, y*cs+F-1-u-pad, x*cs+F-1-v-pad],
// and the bias's sum_{b,y,x} dz[b,m,y,x] as output nout-1 of the map (a tap
// whose input is 1). The batch is cut into units, a sample's band of ny
// output rows (one band of all e rows where a sample fits and the batch
// alone gives the slices), and the units into nsl slices of nu, about
// WG_TARGET and at most a block an SM. A block takes one slice and every
// output of a group of mg maps (all M unless a row of them does not fit
// shared memory): it stages nbs units at a time, their dz rows of its
// maps and the input rows under them, once for every map and tap, each
// element an asynchronous copy (a zero fill off the input; the round's
// copies all in flight at once). Each thread owns a WG_TM x WG_TV register
// tile (maps x taps) and sums the staged positions pg, pg + npg, ... (a
// mixed-radix counter steps them and the copies: no division); a tile's
// npg position groups add by a butterfly within the warp that halves the
// outputs a lane keeps at each level, then warp by warp in order, into
// the slice's sums in shared memory. Slices form clusters of cl blocks:
// after the cluster's barrier, block r adds the r-th share of its group's
// outputs from the cluster's blocks' shared memory in slice order; with
// several clusters, the last block to finish a share (last_block, a
// counter a map group and share) adds the clusters' sums in cluster order.
// Exact f32 multiply-adds on the CUDA cores and no atomic sum: one order
// for given shapes.
constexpr int WG_TM = 4, WG_TV = 8;   // a thread's tile: maps x taps
constexpr int WG_MAX_THREADS = 256;   // a block's: it holds an SM's registers
constexpr int WG_TARGET = 96;         // slices wanted (on the H100 at
                                      // mnist_cnn's levels, 96 ran faster
                                      // than 64 and than 132)
constexpr int WG_CLUSTER = 8;         // blocks a cluster, at most (portable)

struct WgradPlan {
  int nout;           // F*F*Cin weights and the bias, a map
  int mg, ngr;        // maps a block, map groups (the grid's y)
  int ny, nbn;        // output rows a band, bands a sample
  int nu, nbs;        // units a slice, units staged at a time
  int nsl, cl, nslp;  // slices, blocks a cluster, slices padded to clusters
  int hb, sp;         // staged input rows of a band, (ny-1)*cs + F; columns
  int tiles, npg;     // thread tiles of the group, position groups a tile
  int threads, passes;   // tiles a thread takes, one after another
  int smem_floats;
};

__host__ __device__ inline long long cdivl(long long a, long long b) {
  return (a + b - 1) / b;
}

// floats a unit stages: mg maps' dz rows (ny x e), then the Cin x hb x sp
// input rows under them
inline long long wgrad_unit_floats(int ny, int mg, int e, int Cin, int F,
                                   int cs) {
  const long long sp = (long long)(e - 1) * cs + F;
  return (long long)mg * ny * e + (long long)Cin * ((ny - 1) * cs + F) * sp;
}

inline WgradPlan wgrad_plan(int B, int M, int Cin, int F, int e, int cs) {
  WgradPlan p;
  p.nout = F * F * Cin + 1;
  p.sp = (e - 1) * cs + F;
  auto unit = [&](int ny, int mg) {
    return wgrad_unit_floats(ny, mg, e, Cin, F, cs);
  };
  // 48 KB where a row of one map fits it, else what a block can opt in to
  const long long lim = unit(1, 1) <= STAGE_FLOATS
                            ? STAGE_FLOATS
                            : (long long)(SMEM_OPT_IN / sizeof(float));
  p.ngr = 1;
  auto fits = [&](int mg) {   // a row's staging; the slice's sums (in
    return unit(1, mg) <= lim   // global memory past a pass of tiles)
           && (cdiv(mg, WG_TM) * cdiv(p.nout, WG_TV) > WG_MAX_THREADS
               || (long long)mg * p.nout + WG_MAX_THREADS <= lim);
  };
  while (p.ngr < M && !fits(cdiv(M, p.ngr))) ++p.ngr;
  p.mg = cdiv(M, p.ngr);
  p.ngr = cdiv(M, p.mg);
  const long long want = cdiv(WG_TARGET, p.ngr);
  int ny = e;
  while (ny > 1 && unit(ny, p.mg) > lim) --ny;
  if (B < want)   // bands enough for the slices wanted
    ny = std::min(ny, cdiv(e, (int)std::min<long long>(e, cdivl(want, B))));
  p.ny = ny;
  p.nbn = cdiv(e, ny);
  const long long units = (long long)B * p.nbn;
  // one wave: at most SM_COUNT blocks, slices padded to whole clusters
  const int cap = std::max(1, SM_COUNT / p.ngr);
  const int nsl_max = cap <= WG_CLUSTER ? cap : cap / WG_CLUSTER * WG_CLUSTER;
  p.nu = (int)std::max({1LL, (units + want / 2) / want, cdivl(units, nsl_max)});
  p.nsl = (int)cdivl(units, p.nu);
  p.nbs = p.nbn > 1 ? 1
          : (int)std::max(1LL, std::min<long long>(p.nu, lim / unit(ny, p.mg)));
  p.cl = std::min(WG_CLUSTER, p.nsl);
  p.nslp = cdiv(p.nsl, p.cl) * p.cl;
  p.hb = (ny - 1) * cs + F;
  p.tiles = cdiv(p.mg, WG_TM) * cdiv(p.nout, WG_TV);
  const int round_pos = p.nbs * ny * e;
  p.npg = 1;
  while (2 * p.npg * p.tiles <= WG_MAX_THREADS && p.npg < round_pos)
    p.npg *= 2;
  p.threads = std::min(WG_MAX_THREADS, cdiv(p.tiles * p.npg, 32) * 32);
  p.passes = cdiv(p.tiles, p.threads / p.npg);
  p.smem_floats = (int)std::max<long long>(
      p.nbs * unit(ny, p.mg),
      p.passes > 1 ? p.threads : (long long)p.mg * p.nout + p.threads);
  return p;
}

// A mixed-radix counter, digits d0 < r0, d1 < r1, d2 < r2 and d3, stepped
// by a fixed stride whose own digits are s: a few adds and selects a step.
struct Mixed {
  int d0, d1, d2, d3;
};

__device__ __forceinline__ Mixed mixed_of(int i, int r0, int r1, int r2) {
  Mixed d;
  d.d0 = i % r0;
  i /= r0;
  d.d1 = i % r1;
  i /= r1;
  d.d2 = i % r2;
  d.d3 = i / r2;
  return d;
}

__device__ __forceinline__ void mixed_step(Mixed& d, const Mixed& s, int r0,
                                           int r1, int r2) {
  d.d0 += s.d0;
  int c = d.d0 >= r0;
  d.d0 -= c * r0;
  d.d1 += s.d1 + c;
  c = d.d1 >= r1;
  d.d1 -= c * r1;
  d.d2 += s.d2 + c;
  c = d.d2 >= r2;
  d.d2 -= c * r2;
  d.d3 += s.d3 + c;
}

// The cluster's barrier in two halves: every thread of its blocks arrives
// (release: its writes before, shared ones included, are published), and
// waits for the others (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A float of block ``rank``'s shared memory at the address of ``p`` in
// this block's (distributed shared memory; after a cluster barrier).
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p), r;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(r));
  return v;
}

// An asynchronous copy of a float from global to shared memory, or of a
// zero where ``real`` is false (no byte read); cp_wait waits for the
// thread's copies.
__device__ __forceinline__ void cp_float(float* dst, const float* src,
                                         bool real) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(d), "l"(src), "r"(real ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Output o of the group of maps from m0 (o = m*nout + tap) to dw or dbias.
__device__ __forceinline__ void wgrad_store(float* dw, float* dbias, int m0,
                                            int nout, int o, float v) {
  const int m = o / nout, t = o - m * nout;
  if (t == nout - 1) dbias[m0 + m] = v;
  else dw[(size_t)(m0 + m) * (nout - 1) + t] = v;
}

// A thread tile's maps and taps in a unit's staged floats: moff[jm] the
// map's dz rows, ooff[jv] the tap's input offset from a position's, jb the
// bias's slot (-1: none). Maps past the group repeat its last (their sums
// are not stored); taps past nout read offset 0. Tiles take the maps first
// (tile % ntm), so the tiles of a warp mostly share their taps.
__device__ __forceinline__ void wgrad_tile(const ConvGeom& g,
                                           const WgradPlan& p, int tile,
                                           int mgc, int* moff, int* ooff,
                                           int& jb) {
  const int ntm = cdiv(p.mg, WG_TM), tm = tile % ntm, tv = tile / ntm;
  jb = -1;
#pragma unroll
  for (int jm = 0; jm < WG_TM; ++jm)
    moff[jm] = min(tm * WG_TM + jm, mgc - 1) * p.ny * g.e;
#pragma unroll
  for (int jv = 0; jv < WG_TV; ++jv) {
    const int t = tv * WG_TV + jv, ci = t % g.Cin, uv = t / g.Cin;
    ooff[jv] = t < p.nout - 1 ? ci * p.hb * p.sp + (g.F - 1 - uv / g.F) * p.sp
                                    + g.F - 1 - uv % g.F
                              : 0;
    if (t == p.nout - 1) jb = jv;
  }
}

// A thread's walks of a staging round of ny output rows (k_wgrad): the
// digits of its dz elements tid and tid + nt (column, row, map, unit) and
// of the step 2 nt, of its input elements (column, row, channel, unit)
// likewise, of its first position (column, row, unit) and of the step npg.
// Two chains of elements a thread: their steps do not wait on each other.
struct WgradWalk {
  int ny;
  Mixed dd, dd1, ds, di, di1, dis, q, qs;
};

__device__ __forceinline__ WgradWalk wgrad_walk(const ConvGeom& g,
                                                const WgradPlan& p, int ny,
                                                int mgc, int pg) {
  const int tid = threadIdx.x, nt = blockDim.x, hb = (ny - 1) * g.cs + g.F;
  WgradWalk w;
  w.ny = ny;
  w.dd = mixed_of(tid, g.e, ny, mgc);
  w.dd1 = mixed_of(tid + nt, g.e, ny, mgc);
  w.ds = mixed_of(2 * nt, g.e, ny, mgc);
  w.di = mixed_of(tid, p.sp, hb, g.Cin);
  w.di1 = mixed_of(tid + nt, p.sp, hb, g.Cin);
  w.dis = mixed_of(2 * nt, p.sp, hb, g.Cin);
  w.q = mixed_of(pg, g.e, ny, 1 << 30);
  w.qs = mixed_of(p.npg, g.e, ny, 1 << 30);
  return w;
}

// One level of the position groups' butterfly: lane l and lane l ^ o
// swap halves of the 2H outputs each keeps, the lane with bit o set
// keeping the upper half; each adds the other's half to its own.
template <int H>
__device__ __forceinline__ void wgrad_halve(float* acc, int o, int lane) {
  const bool up = lane & o;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = up ? acc[k] : acc[k + H];
    const float keep = up ? acc[k + H] : acc[k];
    acc[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// part: ncl = nslp / cl cluster sums of M x nout (with more than one
// cluster), then (with more than one pass) the nslp slices' sums; ctr: ngr
// x cl zeroed counters.
__global__ void __launch_bounds__(WG_MAX_THREADS)
k_wgrad(ConvGeom g, WgradPlan p, const float* __restrict__ dz,
        const float* __restrict__ in, float* __restrict__ part,
        unsigned* __restrict__ ctr, float* __restrict__ dw,
        float* __restrict__ dbias) {
  extern __shared__ float sm[];
  constexpr int NV = WG_TM * WG_TV;   // 32: a lane an output of a tile
  const int e = g.e, cs = g.cs, F = g.F, sp = p.sp, nout = p.nout;
  const int tid = threadIdx.x, nt = blockDim.x, npg = p.npg;
  const int lane = tid & 31, seg = min(npg, 32);
  const int sl = blockIdx.x, m0 = blockIdx.y * p.mg;
  const int mgc = min(p.mg, g.M - m0);   // the group's maps
  const int dzu = p.mg * p.ny * e, inu = g.Cin * p.hb * sp;   // a unit's
  float* sin = sm + p.nbs * dzu;          // staged dz, then its input rows
  const long long MN = (long long)g.M * nout, u0 = (long long)sl * p.nu;
  const int ncl = p.nslp / p.cl;
  const size_t go = (size_t)m0 * nout;
  float* csum = part + go;                // the clusters' sums
  float* bp = p.passes > 1                // the slice's sums (mgc x nout):
                  ? part + (ncl > 1 ? ncl : 0) * MN + sl * MN + go
                  : sm;                   // in global memory, or over the
  float* red = sm + p.mg * nout;          // staged rows; the warps' sums
  const long long units = (long long)g.B * p.nbn;
  const long long u1 = min(units, u0 + p.nu);   // below u0: a padding slice
  const size_t dzs = (size_t)g.M * g.c * g.c;   // dz floats a sample
  const int pg = tid & (npg - 1), ntm = cdiv(p.mg, WG_TM);
  const int per_pass = nt / npg;
  int tile = tid / npg, moff[WG_TM], ooff[WG_TV], jb;
  wgrad_tile(g, p, tile, mgc, moff, ooff, jb);   // before the wait: they
  WgradWalk wk = wgrad_walk(                      // read no memory
      g, p, min(p.ny, e - (int)(u0 % p.nbn) * p.ny), mgc, pg);
  pdl_wait();
  for (int pass = 0; pass < p.passes; ++pass) {
    if (pass) {
      tile += per_pass;
      wgrad_tile(g, p, tile, mgc, moff, ooff, jb);
    }
    const int tm = tile % ntm, tv = tile / ntm;
    float acc[NV];   // acc[jm * WG_TV + jv]
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = 0.0f;
    for (long long u = u0; u < u1; u += p.nbs) {
      const int nbt = (int)min((long long)p.nbs, u1 - u);
      const int b = (int)(u / p.nbn), y0 = (int)(u % p.nbn) * p.ny;
      const int ny = min(p.ny, e - y0), hb = (ny - 1) * cs + F;
      __syncthreads();   // the staged rows before are summed
      // dz digits (column, row, map, unit); input (column, row, channel,
      // unit): consecutive threads take consecutive columns of a row, each
      // element an asynchronous copy (all of the round's in flight at once;
      // a padding element a zero fill)
      const int ndz = nbt * mgc * ny * e, nin = nbt * g.Cin * hb * sp;
      const float* dzb = dz + b * dzs + (size_t)m0 * g.c * g.c + y0 * g.c;
      const float* inb = in + (size_t)b * g.sb;
      if (ny != wk.ny) wk = wgrad_walk(g, p, ny, mgc, pg);
      auto dz_copy = [&](const Mixed& d) {
        cp_float(sm + ((d.d3 * p.mg + d.d2) * p.ny + d.d1) * e + d.d0,
                 dzb + d.d3 * dzs + (size_t)d.d2 * g.c * g.c + d.d1 * g.c
                     + d.d0,
                 true);
      };
      auto in_copy = [&](const Mixed& d) {
        const int iy = y0 * cs + d.d1 - g.pad, ix = d.d0 - g.pad;
        const bool inside = iy >= 0 && iy < g.W && ix >= 0 && ix < g.W;
        cp_float(sin + ((d.d3 * g.Cin + d.d2) * p.hb + d.d1) * sp + d.d0,
                 inb + (inside ? (size_t)d.d3 * g.sb + (size_t)d.d2 * g.sc
                                     + iy * g.W + ix
                               : 0),
                 inside);
      };
      Mixed d0 = wk.dd, d1 = wk.dd1;
#pragma unroll 2
      for (int i = tid; i < ndz; i += 2 * nt) {
        dz_copy(d0);
        if (i + nt < ndz) dz_copy(d1);
        mixed_step(d0, wk.ds, e, ny, mgc);
        mixed_step(d1, wk.ds, e, ny, mgc);
      }
      d0 = wk.di;
      d1 = wk.di1;
#pragma unroll 2
      for (int i = tid; i < nin; i += 2 * nt) {
        in_copy(d0);
        if (i + nt < nin) in_copy(d1);
        mixed_step(d0, wk.dis, sp, hb, g.Cin);
        mixed_step(d1, wk.dis, sp, hb, g.Cin);
      }
      cp_wait();
      __syncthreads();
      if (tile < p.tiles) {   // positions (column, row, unit) pg, pg + npg,
        const int npos = nbt * ny * e;   // two a step: their loads together
        Mixed q = wk.q;
        for (int i = pg; i < npos; i += 2 * npg) {
          const int pd0 = q.d2 * dzu + q.d1 * e + q.d0;
          const int pi0 = q.d2 * inu + q.d1 * cs * sp + q.d0 * cs;
          mixed_step(q, wk.qs, e, ny, 1 << 30);
          const bool two = i + npg < npos;
          const int pd1 = two ? q.d2 * dzu + q.d1 * e + q.d0 : pd0;
          const int pi1 = two ? q.d2 * inu + q.d1 * cs * sp + q.d0 * cs : pi0;
          mixed_step(q, wk.qs, e, ny, 1 << 30);
          float dv0[WG_TM], dv1[WG_TM], xv0[WG_TV], xv1[WG_TV];
#pragma unroll
          for (int jm = 0; jm < WG_TM; ++jm) {
            dv0[jm] = sm[pd0 + moff[jm]];
            dv1[jm] = sm[pd1 + moff[jm]];
          }
#pragma unroll
          for (int jv = 0; jv < WG_TV; ++jv) {
            xv0[jv] = jv == jb ? 1.0f : sin[pi0 + ooff[jv]];
            xv1[jv] = jv == jb ? 1.0f : sin[pi1 + ooff[jv]];
          }
#pragma unroll
          for (int jm = 0; jm < WG_TM; ++jm)
#pragma unroll
            for (int jv = 0; jv < WG_TV; ++jv)
              acc[jm * WG_TV + jv] += dv0[jm] * xv0[jv];
          if (two)
#pragma unroll
            for (int jm = 0; jm < WG_TM; ++jm)
#pragma unroll
              for (int jv = 0; jv < WG_TV; ++jv)
                acc[jm * WG_TV + jv] += dv1[jm] * xv1[jv];
        }
      }
    }
    // the tile's position groups: a butterfly within the warp that halves
    // the outputs a lane keeps at each level (lane l of a group of seg then
    // holds outputs (l % seg) * NV / seg, ...), then warp by warp in order
    if (seg > 1) wgrad_halve<16>(acc, seg >> 1, lane);
    if (seg > 2) wgrad_halve<8>(acc, seg >> 2, lane);
    if (seg > 4) wgrad_halve<4>(acc, seg >> 3, lane);
    if (seg > 8) wgrad_halve<2>(acc, seg >> 4, lane);
    if (seg > 16) wgrad_halve<1>(acc, seg >> 5, lane);
    __syncthreads();   // the staged rows are summed: reuse them
    const bool live = tile < p.tiles;
    if (npg <= 32) {
      const int nk = NV / seg, k0 = pg * nk;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int m = tm * WG_TM + (k0 + k) / WG_TV;
        const int t = tv * WG_TV + (k0 + k) % WG_TV;
        if (live && k < nk && m < mgc && t < nout) bp[m * nout + t] = acc[k];
      }
    } else {   // one pass
      red[tid] = acc[0];   // lane l: output l of its warp's sum
      __syncthreads();
      const int m = tm * WG_TM + pg / WG_TV, t = tv * WG_TV + pg % WG_TV;
      if (live && pg < 32 && m < mgc && t < nout) {
        float s = 0.0f;
        for (int w = 0; w < npg / 32; ++w) s += red[tid + 32 * w];
        bp[m * nout + t] = s;
      }
    }
  }
  // the cluster's slices: block r adds the r-th share of the outputs from
  // each block's shared memory in slice order; then the clusters
  cluster_arrive();
  cluster_wait();
  const int r = sl % p.cl, c = sl / p.cl;
  const int ng = mgc * nout, share = cdiv(ng, p.cl);
  const int o0 = r * share, o1 = min(ng, o0 + share);
  const int kn = min(p.cl, p.nsl - c * p.cl);   // the cluster's slices
  for (int o = o0 + tid; o < o1; o += nt) {
    float v[WG_CLUSTER];
#pragma unroll
    for (int k = 0; k < WG_CLUSTER; ++k)
      v[k] = k >= kn          ? 0.0f
             : p.passes == 1 ? ld_cluster(bp + o, k)
                             : __ldcg(bp + (k - r) * MN + o);
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < WG_CLUSTER; ++k)
      if (k < kn) s += v[k];
    if (ncl == 1) wgrad_store(dw, dbias, m0, nout, o, s);
    else csum[c * MN + o] = s;
  }
  // the block's reads of the others' shared memory are done (they exit
  // only once every block of the cluster has arrived here)
  cluster_arrive();
  if (ncl > 1 && last_block(ctr + blockIdx.y * p.cl + r, ncl)) {
    for (int o = o0 + tid; o < o1; o += nt)
      wgrad_store(dw, dbias, m0, nout, o, sum_slices<16>(csum + o, MN, ncl));
  }
  cluster_wait();
  // the next stage starts only now: started early, its blocks sat on the
  // SMs this grid left free and ran slower (on the H100, the conv2 input
  // gradient after this stage at mnist_cnn: 11.2 against 6.9 us a step)
  pdl_trigger();
}

// The level's weight and bias gradients, started by programmatic dependent
// launch on clusters of wgrad_plan's cl slices; ``part`` holds
// wgrad_part_floats, ``ctr`` wgrad_counters zeroed counters.
inline int conv_wgrad(cudaStream_t s, const ConvGeom& g, const float* dz,
                      const float* in, float* part, unsigned* ctr, float* dw,
                      float* dbias) {
  const WgradPlan p = wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs);
  const size_t smem = sizeof(float) * p.smem_floats;
  if (!smem_opt_in(k_wgrad, smem)) return ERR_STAGE_SMEM;
  CHECK(launch_pdl(k_wgrad, dim3(p.nslp, p.ngr), dim3(p.threads), smem, p.cl,
                   s, g, p, dz, in, part, ctr, dw, dbias));
  return 0;
}

// Floats of a level's weight-gradient slice and cluster sums, and its
// counters.
inline long long wgrad_part_floats(const ConvGeom& g) {
  const WgradPlan p = wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs);
  const long long ncl = p.nslp / p.cl;
  return ((ncl > 1 ? ncl : 0) + (p.passes > 1 ? p.nslp : 0)) * g.M * p.nout;
}
inline long long wgrad_counters(const ConvGeom& g) {
  const WgradPlan p = wgrad_plan(g.B, g.M, g.Cin, g.F, g.e, g.cs);
  return (long long)p.ngr * p.cl;
}

// ---- Input gradient: din[b, ci, i, j] = sum over m, u, v (in that order)
// of w[m, (u*F+v)*Cin + ci] * dz[b, m, y, x] over the outputs whose tap
// (u, v) reads (i, j): y*cs + F-1-u-pad == i, y < e (x likewise). One block
// a (row band, input map, sample) on ``rows`` input rows of the W x W map,
// a thread a position (a thread every ``threads`` positions where a band
// holds more than DG_MAX_THREADS; at least DG_MIN_THREADS threads, for the
// staging). It stages its map's weights and its sample's dz, dilated by
// the stride and shifted by off = F-1-pad onto a zero canvas (dzd[m][Y][X]
// = dz[m][y][x] at Y = y*cs + off): then every tap is dzd[m][i + u][j + v],
// with no bounds test and no stride test in the sum.
// Bands are cut so that a batch of 20 at mnist_cnn's conv2 gives the card
// at least one block an SM.
constexpr int DG_TARGET = 2 * SM_COUNT;
constexpr int DG_MIN_THREADS = 256, DG_MAX_THREADS = 1024;
constexpr int DG_RB = 4;   // canvas rows a thread stages at a time

struct DgradPlan {
  int rows, nbands, dp, threads, smem_floats;
};

inline int dgrad_band_floats(int rows, int M, int F, int dp) {
  return M * F * F + M * (rows + F - 1) * dp;
}

inline DgradPlan dgrad_plan(int B, int Cin, int W, int M, int F) {
  DgradPlan p;
  p.dp = W + F - 1;
  const int nb = std::min(W, std::max(1, cdiv(DG_TARGET, B * Cin)));
  p.rows = std::min(cdiv(W, nb), std::max(1, DG_MAX_THREADS / W));
  while (p.rows > 1 && dgrad_band_floats(p.rows, M, F, p.dp) > STAGE_FLOATS)
    --p.rows;
  p.nbands = cdiv(W, p.rows);
  p.threads = std::min(DG_MAX_THREADS,
                       std::max(DG_MIN_THREADS, cdiv(p.rows * W, 32) * 32));
  p.smem_floats = dgrad_band_floats(p.rows, M, F, p.dp);
  return p;
}

// The taps of one position, in the order m, u, v: ws the staged weights
// (M x F x F), dm the canvas at (map 0, row il, column j), a map every
// ``mstride`` floats, a row every ``dp``. FT > 0 is F known at compile
// time (the loops unrolled: a runtime-bound loop of loads costs several
// times its arithmetic here); FT == 0 reads F at run time.
template <int FT>
__device__ __forceinline__ float dgrad_taps(int M, int Frt, const float* ws,
                                            const float* dm, int mstride,
                                            int dp) {
  const int F = FT > 0 ? FT : Frt;
  float s = 0.0f;
  for (int m = 0; m < M; ++m, ws += F * F, dm += mstride) {
#pragma unroll
    for (int u = 0; u < F; ++u)
#pragma unroll
      for (int v = 0; v < F; ++v) s += ws[u * F + v] * dm[u * dp + v];
  }
  return s;
}

// The block's staging: its map's weights and its band's canvas into
// shared memory; returns the band's positions, nr * W. Every thread of the
// block calls it: it synchronises the block. The canvas is staged a
// column a thread (of each chunk of cw = min(dp, blockDim.x) columns, the
// thread's column fixed and its rows every blockDim.x / cw, DG_RB loads in
// flight), so that no staged element costs an integer division at stride
// 1. Then each thread sums the positions t = threadIdx.x, + blockDim.x,
// ... below the count (dgrad_sum).
__device__ __forceinline__ int dgrad_stage(const ConvGeom& g,
                                           const DgradPlan& p,
                                           const float* __restrict__ w,
                                           const float* __restrict__ dz) {
  pdl_wait();   // the kernels are started by programmatic dependent launch
  pdl_trigger();
  extern __shared__ float sm[];
  const int F = g.F, FF = F * F, M = g.M, dp = p.dp, cs = g.cs;
  const int b = blockIdx.z, ci = blockIdx.y, i0 = blockIdx.x * p.rows;
  const int nr = min(p.rows, g.W - i0), hr = nr + F - 1;
  const int off = F - 1 - g.pad, tid = threadIdx.x, nt = blockDim.x;
  float* ws = sm;            // w[m, u, v, ci]: M x F x F
  float* dzd = sm + M * FF;  // M x hr x dp, canvas rows i0 ...
  for (int k = tid; k < M * FF; k += nt)
    ws[k] = w[(size_t)(k / FF) * FF * g.Cin + (k % FF) * g.Cin + ci];
  const int cw = min(dp, nt), rstep = nt / cw, nrows = M * hr;
  for (int c0 = 0; c0 < dp && tid < rstep * cw; c0 += cw) {
    const int col = c0 + tid % cw;
    if (col >= dp) break;
    const int X = col - off;   // the canvas column's dz column x*cs
    const int x = cs == 1 ? X : X / cs;
    const bool colok = X >= 0 && (cs == 1 || X % cs == 0) && x < g.e;
    const float* dzb = dz + (size_t)b * M * g.c * g.c + (colok ? x : 0);
    int r = tid / cw, m = r / hr, h = r % hr;   // the thread's first row
    while (r < nrows) {
      float v[DG_RB];
      int at[DG_RB];
#pragma unroll
      for (int k = 0; k < DG_RB; ++k) {
        const int Y = i0 + h - off, y = cs == 1 ? Y : Y / cs;
        const bool ok = r < nrows && colok && Y >= 0
                        && (cs == 1 || Y % cs == 0) && y < g.e;
        v[k] = ok ? dzb[((size_t)m * g.c + y) * g.c] : 0.0f;
        at[k] = r < nrows ? r * dp + col : -1;
        r += rstep;   // the next row: (m, h) advanced without a division
        h += rstep;
        while (h >= hr) { h -= hr; ++m; }
      }
#pragma unroll
      for (int k = 0; k < DG_RB; ++k)
        if (at[k] >= 0) dzd[at[k]] = v[k];
    }
  }
  __syncthreads();
  return nr * g.W;
}

// The input gradient at band position t (input row i0 + t / W, column
// t % W) from dgrad_stage's shared memory.
__device__ __forceinline__ float dgrad_sum(const ConvGeom& g,
                                           const DgradPlan& p, int t) {
  extern __shared__ float sm[];
  const int F = g.F, M = g.M, dp = p.dp;
  const int hr = min(p.rows, g.W - (int)blockIdx.x * p.rows) + F - 1;
  const float* dm = sm + M * F * F + (t / g.W) * dp + t % g.W;
  switch (F) {
    case 2: return dgrad_taps<2>(M, F, sm, dm, hr * dp, dp);
    case 3: return dgrad_taps<3>(M, F, sm, dm, hr * dp, dp);
    case 4: return dgrad_taps<4>(M, F, sm, dm, hr * dp, dp);
    case 5: return dgrad_taps<5>(M, F, sm, dm, hr * dp, dp);
    default: return dgrad_taps<0>(M, F, sm, dm, hr * dp, dp);
  }
}

// ---- The input gradient at wide levels (megastep_deep.cu
// k_conv_dgrad_tiled): the same sums as a register-tiled implicit GEMM,
// rows the input maps, columns a sample's positions, depth (m, u, v). A
// block takes a tile of cit = DT_TCI * g input maps and a band of ``rows``
// input rows of one sample; each thread a DT_TCI x DT_TJ register tile
// (input maps x neighbouring positions of one row). The depth runs in
// chunks of km maps, double-buffered: each chunk's weights of the tile's
// maps and its canvas rows (the band's rows + F - 1, dpp = nj * DT_TJ +
// F - 1 columns wide: the last tile of a row reads past the canvas into
// zeros) are staged once for the whole tile. Each output's sum stays in
// one thread in the order m, u, v, so it equals the band path's.
//
// Which path a level takes: the band path (dgrad_plan) keeps levels of
// few input maps, where a tile of input maps would sit mostly empty and
// one wide launch of short sums is the latency floor (mnist_cnn's conv2,
// Cin 4; galaxy_rbf's level 2, Cin 8; the geometry and aux configs, at
// most 20); the tiled path takes Cin >= DT_MIN_CIN (the GTSRB column's
// levels 2 and 3, Cin 100 and 150), for filters 2 to DT_FMAX (compiled
// per F) and rows of at most DT_MAX_THREADS tiles. Among tile shapes (g,
// rows) the plan takes the one whose grid fills the card, then the least
// estimated time: the busiest SM's warps (at least DT_MIN_WARPS, below
// which a warp's latency and not the SM's issue rate sets the pace) times
// a thread's instructions a map (its FMAs and shared loads, and
// DT_STAGE_COST a staged float shared by the block's threads), then the
// fewer blocks.
constexpr int DT_TCI = 4, DT_TJ = 3;
constexpr int DT_MIN_CIN = 32, DT_FMIN = 2, DT_FMAX = 7;
constexpr int DT_MAX_G = 8, DT_MAX_THREADS = 512, DT_MAX_KM = 16;
constexpr int DT_MIN_WARPS = 4, DT_STAGE_COST = 4;

struct DgradTilePlan {
  int tiled, g, cit, nct, rows, nbands, nj, dpp, km, nch, threads,
      smem_floats;
};

// Floats a map of a chunk stages: its weights of the tile's input maps,
// then its canvas rows.
inline int dgrad_tile_map_floats(int g, int rows, int F, int dpp) {
  return F * F * DT_TCI * g + (rows + F - 1) * dpp;
}

// The tile shape at a level, whichever path it takes (tiled 0 where no
// band of one row fits a block).
inline DgradTilePlan dgrad_tile_shape(int B, int Cin, int W, int M, int F) {
  DgradTilePlan p = {};
  p.nj = cdiv(W, DT_TJ);
  p.dpp = p.nj * DT_TJ + F - 1;
  const long long comp =
      (long long)F * (DT_TCI * DT_TJ * F + DT_TJ + 2 * F - 1);
  long long bnum = 0, bden = 1, bnb = 0;
  bool bfill = false;
  for (int g = 1; g <= DT_MAX_G; ++g) {
    const int nct = cdiv(Cin, DT_TCI * g);
    for (int r = 1; r <= W && g * r * p.nj <= DT_MAX_THREADS; ++r) {
      const int sm = dgrad_tile_map_floats(g, r, F, p.dpp);
      if (8LL * sm > (long long)SMEM_OPT_IN) break;
      const int threads = cdiv(g * r * p.nj, 32) * 32;
      const long long nb = (long long)B * nct * cdiv(W, r);
      const long long busiest = (nb + SM_COUNT - 1) / SM_COUNT * (threads / 32);
      const long long num = std::max<long long>(busiest, DT_MIN_WARPS)
                            * (comp * threads + DT_STAGE_COST * sm);
      const bool fill = nb >= SM_COUNT;
      bool better;
      if (!p.tiled) better = true;
      else if (fill != bfill) better = fill;
      else if (num * bden != bnum * threads)
        better = num * bden < bnum * threads;
      else better = nb < bnb;
      if (better) {
        p.tiled = 1;
        p.g = g;
        p.rows = r;
        bnum = num;
        bden = threads;
        bnb = nb;
        bfill = fill;
      }
    }
  }
  if (!p.tiled) return p;
  const int sm = dgrad_tile_map_floats(p.g, p.rows, F, p.dpp);
  p.cit = DT_TCI * p.g;
  p.nct = cdiv(Cin, p.cit);
  p.nbands = cdiv(W, p.rows);
  p.km = std::min(std::min(M, DT_MAX_KM), std::max(1, STAGE_FLOATS / (2 * sm)));
  p.nch = cdiv(M, p.km);
  p.threads = cdiv(p.g * p.rows * p.nj, 32) * 32;
  p.smem_floats = 2 * p.km * sm;
  return p;
}

// The tiled path's plan at a level, or tiled 0 (every field 0) where the
// level takes the band path.
inline DgradTilePlan dgrad_tile_plan(int B, int Cin, int W, int M, int F) {
  if (Cin < DT_MIN_CIN || F < DT_FMIN || F > DT_FMAX) return DgradTilePlan{};
  const DgradTilePlan p = dgrad_tile_shape(B, Cin, W, M, F);
  return p.tiled ? p : DgradTilePlan{};
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

}  // namespace

extern "C" {

// The launch plans above at the given shapes, for the check of their
// mirror in theanet_tpu_torch/ops/stage_plan.py on the card: wgrad_plan's
// 17 fields in order, dgrad_plan's (rows,
// nbands, dp, threads, smem_floats), dgrad_tile_plan's 12, gemm_plan's
// (nks, kslice, part_floats).
void stage_wgrad_plan(int B, int M, int Cin, int F, int e, int cs,
                      long long* out) {
  const WgradPlan p = wgrad_plan(B, M, Cin, F, e, cs);
  const long long v[] = {p.nout, p.mg,  p.ngr, p.ny,    p.nbn,  p.nu,
                         p.nbs,  p.nsl, p.cl,  p.nslp,  p.hb,   p.sp,
                         p.tiles, p.npg, p.threads, p.passes,
                         p.smem_floats};
  for (int k = 0; k < 17; ++k) out[k] = v[k];
}

void stage_dgrad_plan(int B, int Cin, int W, int M, int F, long long* out) {
  const DgradPlan p = dgrad_plan(B, Cin, W, M, F);
  const long long v[] = {p.rows, p.nbands, p.dp, p.threads, p.smem_floats};
  for (int k = 0; k < 5; ++k) out[k] = v[k];
}

void stage_dgrad_tile_plan(int B, int Cin, int W, int M, int F,
                           long long* out) {
  const DgradTilePlan p = dgrad_tile_plan(B, Cin, W, M, F);
  const long long v[] = {p.tiled, p.g,  p.cit, p.nct,     p.rows,
                         p.nbands, p.nj, p.dpp, p.km,      p.nch,
                         p.threads, p.smem_floats};
  for (int k = 0; k < 12; ++k) out[k] = v[k];
}

void stage_gemm_plan(int M, int N, int K, long long* out) {
  const GemmPlan p = gemm_plan(M, N, K);
  out[0] = p.nks;
  out[1] = p.kslice;
  out[2] = p.part_floats;
}

}  // extern "C"

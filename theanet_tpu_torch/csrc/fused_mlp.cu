// The dense tail Hidden -> leaky relu -> dropout -> Softmax, forward and
// backward, for Hopper (sm_90a).
//
// Replaces theanet_tpu/ops/fused_mlp.py::_fwd_kernel and ::_bwd_kernel
// (the FUSED_TAIL Pallas kernels, glued there by jax.custom_vjp). Their
// plain PyTorch versions, the specification this file is held to, are
// theanet_tpu_torch/ops/fused_mlp.py::tail_forward_reference and
// ::tail_backward_reference.
//
// What it computes. Forward: z1 = x W1 + b1, h = leaky(z1) times the
// dropout mask (train: kept where the word's low-24-bit uniform is >=
// pdrop) or (1 - pdrop) (eval), z2 = h W2 + b2, logp = log_softmax(z2);
// it writes logp, h and the mask. Backward, from g = dL/dlogp:
// dz2 = g - softmax * sum(g), dW2 = h^T dz2, db2, dh = dz2 W2^T times the
// mask (train) or (1 - pdrop) (eval), dz1 = dh * leaky'(h) with leaky'
// taken from the sign of the saved h, dx = dz1 W1^T, dW1 = x^T dz1, db1.
//
// What bounds it on the card. At mnist_cnn's tail (x 20 x 720, W1 720 x
// 500, W2 500 x 10) the forward moves ~1.6 MB and does 14.6 MFLOP, the
// backward ~3.1 MB and 29 MFLOP: each under a microsecond of memory time
// at 3.35 TB/s, so both are bound by their few dependent launches.
//
// What the design does about it (the simplest correct form, first): the
// forward is 2 launches (a 16x16 shared-memory tiled GEMM whose epilogue
// applies the bias, activation and dropout; one block per row for the
// 10-wide scores and the log-softmax), the backward 4 (one block per row
// for dz2 and dz1, then three tiled GEMMs, the two weight gradients with
// their bias sums in the same pass). Every product is computed here; no
// library GEMM is called. Each output's sum runs in one fixed order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int MAX_OUT = 8192;     // head width the row kernels take
constexpr int DROP_NONE = 0, DROP_TRAIN = 1, DROP_EVAL = 2;

struct Hidden {   // the GEMM epilogue of z1 (null b1: a plain product)
  const float* b1;
  const int* words;
  float* mask;
  float slope, pdrop, keep;
  int drop;
};

// C (M x N, row-major, ldc = N) = A B, with A (M x K) row-major at lda or,
// TA, stored transposed (K x M) at lda; B (K x N) row-major at ldb or, TB,
// stored transposed (N x K). ``colsum`` (when not null) gets the column
// sums of B, sum_k B[k, n], from the blocks of the first row of tiles.
template <bool TA, bool TB>
__global__ void k_gemm(int M, int N, int K, const float* __restrict__ A,
                       int lda, const float* __restrict__ Bm, int ldb,
                       float* __restrict__ C, float* __restrict__ colsum,
                       Hidden hid) {
  __shared__ float As[TILE][TILE + 1];  // As[m][k]
  __shared__ float Bs[TILE][TILE + 1];  // Bs[k][n]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const bool sums = colsum != nullptr && blockIdx.y == 0 && ty == 0;
  float acc = 0.0f, csum = 0.0f;
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
    if (sums) {
#pragma unroll
      for (int kk = 0; kk < TILE; ++kk) csum += Bs[kk][tx];
    }
    __syncthreads();
  }
  const int m = m0 + ty, n = n0 + tx;
  if (sums && n < N) colsum[n] = csum;
  if (m >= M || n >= N) return;
  const size_t o = (size_t)m * N + n;
  if (hid.b1 == nullptr) {
    C[o] = acc;
    return;
  }
  const float z = acc + hid.b1[n];
  float h = fmaxf(z, 0.0f) + fminf(z, 0.0f) * hid.slope;
  float keep = 1.0f;
  if (hid.drop == DROP_TRAIN) {
    const float u = (float)(hid.words[o] & 0xFFFFFF) * (1.0f / 16777216.0f);
    keep = u >= hid.pdrop ? 1.0f : 0.0f;
    h = h * keep;
  } else if (hid.drop == DROP_EVAL) {
    h = h * hid.keep;
  }
  C[o] = h;
  hid.mask[o] = keep;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One block per row b: z2 = h[b] W2 + b2 (one warp per output), then the
// row's log-softmax m + log(sum exp(z2 - m)) by the first warp.
__global__ void k_head_fwd(int NH, int O, const float* __restrict__ h,
                           const float* __restrict__ w2,
                           const float* __restrict__ b2,
                           float* __restrict__ logp) {
  extern __shared__ float z[];
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const float* hb = h + (size_t)b * NH;
  for (int j = warp; j < O; j += nw) {
    float acc = 0.0f;
    for (int k = lane; k < NH; k += 32) acc += hb[k] * w2[(size_t)k * O + j];
    acc = warp_sum(acc);
    if (lane == 0) z[j] = acc + b2[j];
  }
  __syncthreads();
  if (warp != 0) return;
  float m = -INFINITY;
  for (int j = lane; j < O; j += 32) m = fmaxf(m, z[j]);
  m = warp_max(m);
  float s = 0.0f;
  for (int j = lane; j < O; j += 32) s += expf(z[j] - m);
  const float lse = m + logf(warp_sum(s));
  for (int j = lane; j < O; j += 32) logp[(size_t)b * O + j] = z[j] - lse;
}

// One block per row b: dz2 = g - exp(logp) * sum(g) (first warp), then
// for every hidden unit dz1 = (dz2 . W2[k]) * drop * leaky'(h).
__global__ void k_head_bwd(int NH, int O, const float* __restrict__ g,
                           const float* __restrict__ logp,
                           const float* __restrict__ w2,
                           const float* __restrict__ h,
                           const float* __restrict__ mask, float slope,
                           int drop, float keep, float* __restrict__ dz2,
                           float* __restrict__ dz1) {
  extern __shared__ float d[];
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* gb = g + (size_t)b * O;
  if (warp == 0) {
    float s = 0.0f;
    for (int j = lane; j < O; j += 32) s += gb[j];
    s = warp_sum(s);
    for (int j = lane; j < O; j += 32) {
      const float v = gb[j] - expf(logp[(size_t)b * O + j]) * s;
      d[j] = v;
      dz2[(size_t)b * O + j] = v;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < NH; k += blockDim.x) {
    const float* wk = w2 + (size_t)k * O;
    float acc = 0.0f;
    for (int j = 0; j < O; ++j) acc += d[j] * wk[j];
    const size_t o = (size_t)b * NH + k;
    if (drop == DROP_TRAIN) acc = acc * mask[o];
    else if (drop == DROP_EVAL) acc = acc * keep;
    dz1[o] = acc * (h[o] > 0.0f ? 1.0f : slope);
  }
}

template <bool TA, bool TB>
cudaError_t gemm(cudaStream_t s, int M, int N, int K, const float* A, int lda,
                 const float* Bm, int ldb, float* C, float* colsum,
                 Hidden hid) {
  dim3 block(TILE, TILE), grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  k_gemm<TA, TB><<<grid, block, 0, s>>>(M, N, K, A, lda, Bm, ldb, C, colsum,
                                        hid);
  return cudaGetLastError();
}

int check_dims(int B, int K, int NH, int O) {
  if (B <= 0 || K <= 0 || NH <= 0 || O <= 0) return -1;
  if (O > MAX_OUT || (B + TILE - 1) / TILE > 65535 ||
      (K + TILE - 1) / TILE > 65535 || (NH + TILE - 1) / TILE > 65535)
    return -2;
  return 0;
}

}  // namespace

#define CHECK(expr)                        \
  do {                                     \
    int e_ = (int)(expr);                  \
    if (e_ != 0) return e_;                \
  } while (0)

extern "C" {

const char* fused_mlp_error_string(int code) {
  if (code == -1) return "empty tail dimensions";
  if (code == -2) return "the tail is too large for the kernel's grid or the head's shared memory";
  return cudaGetErrorString((cudaError_t)code);
}

// Forward of B rows: x (B, K), w1 (K, NH), b1 (NH), w2 (NH, O), b2 (O);
// words (B, NH) int32 when drop is DROP_TRAIN; writes logp (B, O), h and
// mask (B, NH). Two launches on ``stream``; returns 0 or the first error.
int fused_mlp_forward(const float* x, const float* w1, const float* b1,
                      const float* w2, const float* b2, const int* words,
                      float* logp, float* h, float* mask, int B, int K,
                      int NH, int O, float slope, float pdrop, float keep,
                      int drop, int device, void* stream) {
  CHECK(check_dims(B, K, NH, O));
  CHECK(cudaSetDevice(device));
  cudaStream_t s = (cudaStream_t)stream;
  Hidden hid{b1, words, mask, slope, pdrop, keep, drop};
  CHECK((gemm<false, false>(s, B, NH, K, x, K, w1, NH, h, nullptr, hid)));
  k_head_fwd<<<B, 256, O * sizeof(float), s>>>(NH, O, h, w2, b2, logp);
  return (int)cudaGetLastError();
}

// Backward from g = dL/dlogp (B, O) and the forward's saved x, w1, w2, h,
// mask, logp: writes dx (B, K), dw1 (K, NH), db1 (NH), dw2 (NH, O),
// db2 (O); dz2 (B, O) and dz1 (B, NH) are scratch. Four launches.
int fused_mlp_backward(const float* x, const float* w1, const float* w2,
                       const float* h, const float* mask, const float* logp,
                       const float* g, float* dx, float* dw1, float* db1,
                       float* dw2, float* db2, float* dz2, float* dz1, int B,
                       int K, int NH, int O, float slope, float keep,
                       int drop, int device, void* stream) {
  CHECK(check_dims(B, K, NH, O));
  CHECK(cudaSetDevice(device));
  cudaStream_t s = (cudaStream_t)stream;
  const Hidden plain{nullptr, nullptr, nullptr, 0.0f, 0.0f, 1.0f, DROP_NONE};
  k_head_bwd<<<B, 256, O * sizeof(float), s>>>(NH, O, g, logp, w2, h, mask,
                                                slope, drop, keep, dz2, dz1);
  CHECK(cudaGetLastError());
  // dx = dz1 W1^T: W1 (K, NH) is W1^T stored transposed
  CHECK((gemm<false, true>(s, B, K, NH, dz1, NH, w1, NH, dx, nullptr, plain)));
  // dW1 = x^T dz1 (x stored (B, K)), db1 = column sums of dz1
  CHECK((gemm<true, false>(s, K, NH, B, x, K, dz1, NH, dw1, db1, plain)));
  // dW2 = h^T dz2, db2 = column sums of dz2
  CHECK((gemm<true, false>(s, NH, O, B, h, NH, dz2, O, dw2, db2, plain)));
  return 0;
}

}  // extern "C"

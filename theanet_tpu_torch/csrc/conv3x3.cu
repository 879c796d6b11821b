// 3x3 stride-1 valid convolution (a correlation), forward and backward, in
// f32 or bf16 with f32 accumulation, for Hopper (sm_90a).
//
// Replaces theanet_tpu/ops/conv_pallas.py::_fwd_kernel (forward) and
// ::_bwd_kernel (dx and dw). Their plain PyTorch versions, the
// specification this file is held to, are
// theanet_tpu_torch/ops/conv3x3.py::conv3x3_forward_reference and
// ::conv3x3_backward_reference.
//
// What it computes, for x (B, C, H, H), w (M, C, 3, 3), O = H - 2:
//   forward  z[b, m, oy, ox] = sum over taps (ky, kx) and c of
//            w[m, c, ky, kx] * x[b, c, oy + ky, ox + kx]
//   dx       dx[b, c, y, x] = sum over taps and m of
//            w[m, c, ky, kx] * dz[b, m, y - ky, x - kx] (inside the map)
//   dw       dw[m, c, ky, kx] = sum over b, oy, ox of
//            dz[b, m, oy, ox] * x[b, c, oy + ky, ox + kx]
// Each sum runs in f32 (bf16 operands are widened, so their products are
// exact) and the result is rounded once to the operand type.
//
// What bounds it on the card. At the wide model's conv2 (256 x 64 x 27 x 27
// -> 128 maps) the forward is 23.6 GFLOP on 47 MB of operands: bound by the
// operations, 0.35 ms at the f32 rate, 0.024 ms at the bf16 tensor-core
// rate. The backward is twice the work.
//
// What the design does about it, on the CUDA cores: every product is an
// implicit GEMM (no im2col copy in device memory) of 256-thread blocks, 8 x
// 8 outputs a thread (8 x 4 or 4 x 8 where the rows or columns are the
// short side), operands staged through shared memory 8 deep and widened to
// f32 on the way in:
//   forward  rows m, columns the O*O pixels of one image, depth (tap, c);
//            grid (pixel tiles, map tiles, images)
//   dx       rows c, columns the H*H pixels of one image, depth (tap, m);
//            the flipped-tap full correlation reads dz with a bounds test
//   dw       rows m, columns (tap, c), depth (image, pixel) over a fixed
//            slice of the batch per block; k_dw_reduce then sums the
//            slices in slice order. No atomics: two runs agree to the bit.
// The TPU kernel's lane roll, padded H*W lane grid, crop, valid mask and
// VMEM batch accumulator are Mosaic workarounds and have no counterpart:
// the valid outputs are computed directly. CUDA cores only; wgmma, TMA and
// the tensor cores are later work (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BK = 8, THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund and
// Montgomery's round-up method): the loaders decode every operand index
// with a few such divisions, which the hardware's integer division would
// make the larger part of a tile load.
struct Div {
  unsigned m, s;
  __device__ __forceinline__ int operator()(int n) const {
    return (int)(((unsigned long long)__umulhi((unsigned)n, m) + (unsigned)n)
                 >> s);
  }
};

Div make_div(int d) {
  unsigned s = 0;
  while ((1ull << s) < (unsigned long long)d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return Div{(unsigned)m, s};
}

// The forward as a GEMM of one image z: A(m, k) = w[m, c, tap],
// B(k, p) = x[z, c, oy + ky, ox + kx], k = tap * C + c.
template <typename T>
struct Fwd {
  const T* x;
  const T* w;
  T* out;
  int C, H, M, O;
  Div by_c, by_o, by_3;
  static constexpr bool A_K_FAST = true, B_K_FAST = false;
  __device__ int rows() const { return M; }
  __device__ int cols() const { return O * O; }
  __device__ int depth(int) const { return 9 * C; }
  __device__ float a(int, int m, int k) const {
    const int tap = by_c(k), c = k - tap * C;
    return to_f(w[((size_t)m * C + c) * 9 + tap]);
  }
  __device__ float b(int z, int k, int p) const {
    const int tap = by_c(k), c = k - tap * C;
    const int oy = by_o(p), ox = p - oy * O, ky = by_3(tap), kx = tap - ky * 3;
    return to_f(x[(((size_t)z * C + c) * H + oy + ky) * H + ox + kx]);
  }
  __device__ void store(int z, int m, int p, float v) const {
    out[((size_t)z * M + m) * O * O + p] = from_f<T>(v);
  }
};

// dx of one image z: A(c, k) = w[m, c, tap], B(k, p) = dz[z, m, y - ky,
// x - kx] (0 outside the O x O map), k = tap * M + m.
template <typename T>
struct DGrad {
  const T* dz;
  const T* w;
  T* dx;
  int C, H, M, O;
  Div by_m, by_h, by_3;
  static constexpr bool A_K_FAST = true, B_K_FAST = false;
  __device__ int rows() const { return C; }
  __device__ int cols() const { return H * H; }
  __device__ int depth(int) const { return 9 * M; }
  __device__ float a(int, int c, int k) const {
    const int tap = by_m(k), m = k - tap * M;
    return to_f(w[((size_t)m * C + c) * 9 + tap]);
  }
  __device__ float b(int z, int k, int p) const {
    const int tap = by_m(k), m = k - tap * M;
    const int y = by_h(p), xx = p - y * H, ky = by_3(tap), kx = tap - ky * 3;
    const int sy = y - ky, sx = xx - kx;
    if (sy < 0 || sy >= O || sx < 0 || sx >= O) return 0.0f;
    return to_f(dz[(((size_t)z * M + m) * O + sy) * O + sx]);
  }
  __device__ void store(int z, int c, int p, float v) const {
    dx[((size_t)z * C + c) * H * H + p] = from_f<T>(v);
  }
};

// The partial dw of batch slice z (images z*G .. z*G + G - 1): A(m, r) =
// dz[b, m, p], B(r, j) = x[b, c, oy + ky, ox + kx], r = (b - z*G) * O*O + p,
// j = tap * C + c; written in f32 to part[z].
template <typename T>
struct WGrad {
  const T* x;
  const T* dz;
  float* part;
  int B, C, H, M, O, G;
  Div by_oo, by_c, by_o, by_3;
  static constexpr bool A_K_FAST = true, B_K_FAST = true;
  __device__ int rows() const { return M; }
  __device__ int cols() const { return 9 * C; }
  __device__ int depth(int z) const {
    const int end = min(B, (z + 1) * G);
    return (end - z * G) * O * O;
  }
  __device__ float a(int z, int m, int r) const {
    const int oo = O * O, bl = by_oo(r), p = r - bl * oo;
    return to_f(dz[((size_t)(z * G + bl) * M + m) * oo + p]);
  }
  __device__ float b(int z, int r, int j) const {
    const int oo = O * O, bl = by_oo(r), p = r - bl * oo;
    const int tap = by_c(j), c = j - tap * C;
    const int oy = by_o(p), ox = p - oy * O, ky = by_3(tap), kx = tap - ky * 3;
    return to_f(
        x[(((size_t)(z * G + bl) * C + c) * H + oy + ky) * H + ox + kx]);
  }
  __device__ void store(int z, int m, int j, float v) const {
    part[((size_t)z * M + m) * 9 * C + j] = v;
  }
};

// C(z)[rows, cols] = A(z) @ B(z) for the loader L, one BM x BN tile of one
// z a block (BM = 16 TM, BN = 16 TN). Each thread owns rows ty + 16 i and
// columns tx + 16 j (TM x TN outputs) and sums them over the depth in order
// (f32 fma). The tiles' shared rows are padded by 4 floats so that the
// loads along the depth (K_FAST) land in distinct banks.
template <class L, int TM, int TN>
__global__ void __launch_bounds__(THREADS) k_gemm(const L ld) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int z = blockIdx.z, row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int rows = ld.rows(), cols = ld.cols(), depth = ld.depth(z);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < depth; k0 += BK) {
    // the loader's contiguous index runs along the warp
#pragma unroll
    for (int q = 0; q < (BM * BK) / THREADS; ++q) {
      const int e = tid + THREADS * q;
      const int ka = L::A_K_FAST ? e % BK : e / BM;
      const int ra = L::A_K_FAST ? e / BK : e % BM;
      const int r = row0 + ra, k = k0 + ka;
      As[ka][ra] = (r < rows && k < depth) ? ld.a(z, r, k) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < (BN * BK) / THREADS; ++q) {
      const int e = tid + THREADS * q;
      const int kb = L::B_K_FAST ? e % BK : e / BN;
      const int cb = L::B_K_FAST ? e / BK : e % BN;
      const int c = col0 + cb, k = k0 + kb;
      Bs[kb][cb] = (c < cols && k < depth) ? ld.b(z, k, c) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = row0 + ty + 16 * i, c = col0 + tx + 16 * j;
      if (r < rows && c < cols) ld.store(z, r, c, acc[i][j]);
    }
}

// dw[m, c, tap] = the sum of part[z][m, tap * C + c] over the slices z in
// order, rounded once to the weight type.
template <typename T>
__global__ void k_dw_reduce(const float* __restrict__ part, T* __restrict__ dw,
                            int S, int M, int C) {
  const int n = M * 9 * C;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < S; ++z) s += part[(size_t)z * n + i];
    const int m = i / (9 * C), j = i - m * 9 * C, tap = j / C;
    const int c = j - tap * C;
    dw[((size_t)m * C + c) * 9 + tap] = from_f<T>(s);
  }
}

// the grid of k_gemm<L, TM, TN>
template <int TM, int TN>
dim3 tiles(int rows, int cols, int z) {
  return dim3((cols + 16 * TN - 1) / (16 * TN), (rows + 16 * TM - 1) / (16 * TM),
              z);
}

template <typename T>
cudaError_t forward(const void* x, const void* w, void* out, int B, int C,
                    int H, int M, cudaStream_t s) {
  const int O = H - 2;
  const Fwd<T> ld{(const T*)x, (const T*)w, (T*)out, C, H, M, O,
                  make_div(C), make_div(O), make_div(3)};
  k_gemm<Fwd<T>, 8, 8><<<tiles<8, 8>(M, O * O, B), THREADS, 0, s>>>(ld);
  return cudaGetLastError();
}

// Slices of G = ceil(B / splits) images; ceil(B / G) <= splits of them.
template <typename T>
cudaError_t backward(const void* x, const void* w, const void* dz, void* dx,
                     void* dw, float* part, int B, int C, int H, int M,
                     int splits, cudaStream_t s) {
  const int O = H - 2;
  const DGrad<T> dg{(const T*)dz, (const T*)w, (T*)dx, C, H, M, O,
                    make_div(M), make_div(H), make_div(3)};
  k_gemm<DGrad<T>, 4, 8><<<tiles<4, 8>(C, H * H, B), THREADS, 0, s>>>(dg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int G = (B + splits - 1) / splits, S = (B + G - 1) / G;
  const WGrad<T> wg{(const T*)x, (const T*)dz, part, B, C, H, M, O, G,
                    make_div(O * O), make_div(C), make_div(O), make_div(3)};
  k_gemm<WGrad<T>, 8, 4><<<tiles<8, 4>(M, 9 * C, S), THREADS, 0, s>>>(wg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = M * 9 * C;
  k_dw_reduce<T><<<(n + 255) / 256, 256, 0, s>>>(part, (T*)dw, S, M, C);
  return cudaGetLastError();
}

bool bad_shape(int B, int C, int H, int M) {
  return B < 1 || C < 1 || M < 1 || H < 3 || B > 65535;
}

}  // namespace

extern "C" {

const char* conv3x3_error_string(int code) {
  if (code == -1) return "shape out of the kernel's range (B in [1, 65535], "
                         "C, M >= 1, H >= 3, splits >= 1)";
  return cudaGetErrorString((cudaError_t)code);
}

// x (B, C, H, H), w (M, C, 3, 3), out (B, M, H-2, H-2), contiguous, all f32
// (bf16 == 0) or all bf16. Launches on ``stream`` of ``device``; returns 0
// or the CUDA error of the launch.
int conv3x3_forward(const void* x, const void* w, void* out, int B, int C,
                    int H, int M, int bf16, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (bad_shape(B, C, H, M)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  e = bf16 ? forward<__nv_bfloat16>(x, w, out, B, C, H, M, s)
           : forward<float>(x, w, out, B, C, H, M, s);
  return (int)e;
}

// dz (B, M, H-2, H-2) -> dx (x's shape and type), dw (w's shape and type);
// part is f32 scratch of splits * M * 9 * C floats.
int conv3x3_backward(const void* x, const void* w, const void* dz, void* dx,
                     void* dw, void* part, int B, int C, int H, int M,
                     int splits, int bf16, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (bad_shape(B, C, H, M) || splits < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  e = bf16 ? backward<__nv_bfloat16>(x, w, dz, dx, dw, (float*)part, B, C, H,
                                     M, splits, s)
           : backward<float>(x, w, dz, dx, dw, (float*)part, B, C, H, M,
                             splits, s);
  return (int)e;
}

}  // extern "C"

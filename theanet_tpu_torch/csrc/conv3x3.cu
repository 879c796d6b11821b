// 3x3 stride-1 valid convolution (a correlation), forward and backward, in
// f32 or bf16 with f32 accumulation, on Hopper's tensor cores (sm_90a).
//
// Replaces theanet_tpu/ops/conv_pallas.py::_fwd_kernel (forward) and
// ::_bwd_kernel (dx and dw). Their plain PyTorch versions, the
// specification this file is held to, are
// theanet_tpu_torch/ops/conv3x3.py::conv3x3_forward_reference and
// ::conv3x3_backward_reference; its tiling is ops/conv3x3.py::conv3x3_plan,
// which the C entries take and check against their own needs.
//
// What it computes, for x (B, C, H, H), w (M, C, 3, 3), O = H - 2:
//   forward  z[b, m, oy, ox] = sum over taps (ky, kx) and c of
//            w[m, c, ky, kx] * x[b, c, oy + ky, ox + kx]
//   dx       dx[b, c, y, x] = sum over taps and m of
//            w[m, c, ky, kx] * dz[b, m, y - ky, x - kx] (inside the map)
//   dw       dw[m, c, ky, kx] = sum over b, oy, ox of
//            dz[b, m, oy, ox] * x[b, c, oy + ky, ox + kx]
// Each sum runs in f32 and the result is rounded once to the operand type.
//
// What bounds it on the card. At the wide model's conv2 (256 x 64 x 27 x 27
// -> 128 maps) the forward is 23.6 GFLOP on 65 MB of operands, 363
// operations a byte: just above the H100's bf16 ridge (about 295), so bound
// by the tensor cores, 0.024 ms at the bf16 rate. dx and dw are as much
// work each. A fast form keeps the tensor cores fed and reads each byte
// from device memory once.
//
// What the design does about it:
//   * Tensor cores. bf16 runs mma.sync m16n8k16 (bf16 in, f32 sums). f32
//     runs 3xTF32 m16n8k8: each operand splits once into hi = tf32(a) and
//     lo = tf32(a - hi), and lo*hi + hi*lo + hi*hi is summed in f32, as
//     accurate as f32 FMA at these depths (one TF32 pass misses the f32
//     bound by ~65x; tests/test_torch_conv3x3_plan.py pins both on the CPU).
//     Every one or two MMA steps sum into a fresh partial that joins the
//     f32 sum by a rounded add (mma_step). mma.sync, not wgmma: the kernels
//     reach about 15% of the bf16 peak, so the MMA issue rate is not what
//     holds them back, and wgmma's fixed shared-memory operand layout does
//     not take a per-tap pixel shift.
//   * Activations channel-last in shared memory, the TPU kernel's lane
//     roll turned into an address. A conv tile is a strip of whole output
//     rows of one image (at most 128 pixels, 256 at 64 output channels,
//     so that every warp holds 32 pixels x 64 channels); the block stages
//     the strip's input rows with their 2-pixel halo as [pixel][channel],
//     128 bytes of channels at a time (pitch 144: conflict-free ldmatrix).
//     The MMA operand of tap (ky, kx) at output pixel p is then the staged
//     row p + ky * width + kx: ldmatrix takes one row address a lane, so
//     every tap reads the same staged bytes and nothing moves.
//   * Layout passes in device memory. k_to_cl writes x, and dz with a zero
//     halo of 2, channel-last with channels padded to 64 bytes; k_wprep
//     writes the weights as [tap][out channel][in channel], zero-padded.
//     Every later load is then a 16-byte cp.async along the channels. NCHW
//     planes of odd size (27 x 27) are not 16-byte aligned, so the kernels
//     cannot cp.async them; staging NCHW through registers instead (the
//     transpose on the way into shared memory) was slower on the H100 in
//     every stage than the passes it saves. chip_smoke.py phase 13 prints
//     the passes' time.
//   * One body for the forward and dx. dx is the forward of the padded dz
//     with the taps flipped and the weights transposed to (C, M): the
//     bounds test on every element becomes zeros staged once.
//   * Asynchronous copies. The k loop runs over (channel chunk, tap); the
//     weight tile of step it + 2 (a ring of three) and the stage of the
//     chunk it starts load by cp.async while step it computes.
//   * dw on the same staging: a block computes WG_M maps x WG_C channels x
//     9 taps over a fixed run of (image, strip) units, at most DW_DEPTH
//     terms deep, unit u + 1 loading while unit u computes; dz rows past
//     the strip are staged as zeros. k_dw_reduce sums the slices in slice
//     order: no atomics, two runs agree to the bit.
//   * Ragged edges: channels pad to 64 bytes with zeros, map tiles to the
//     tile size with zero weights, pixels past a strip read a valid staged
//     pixel and are not stored. Every shape the entries take runs this path.
// The TPU kernel's padded H*W lane grid, crop, valid mask and VMEM batch
// accumulator are Mosaic workarounds and have no counterpart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// the tiling constants, as in ops/conv3x3.py
constexpr int THREADS = 256;
constexpr int BM = 128;             // output pixels of a dw strip
// output pixels of a conv tile for BN output channels: 8 warps of 32
// pixels x 64 channels at BN 64, of 32 x BN / 2 otherwise
__host__ __device__ constexpr int conv_bm(int bn) {
  return bn == 64 ? 256 : 128;
}
constexpr int CHUNK = 128;          // bytes of channels staged per pixel
constexpr int PITCH = CHUNK + 16;   // bytes between staged pixels
constexpr int KSTEP = 32;           // bytes of depth per MMA step
constexpr int KSPAN = 2 * KSTEP;    // bytes of depth one partial sums
constexpr int WG_M = 64, WG_C = 32;  // a dw tile: maps x channels x 9 taps
constexpr int SMEM_OPT_IN = 232448;

// the order of the plan's integers (Conv3x3Plan.ints)
enum {
  PF_KP, PF_NP, PF_BN, PF_R, PF_WO, PF_SMEM,   // the forward's conv pass
  PD_KP, PD_NP, PD_BN, PD_R, PD_WO, PD_SMEM,   // dx's conv pass
  PW_R, PW_WO, PW_PER_SLICE, PW_SLICES, PW_CQ, PW_SMEM,  // dw
  N_PLAN
};

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int DZ_PITCH = 144, X_PITCH = 80;  // dw stage pitches
};
template <>
struct Elem<float> {
  static constexpr int DZ_PITCH = 288, X_PITCH = 160;
};

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n of this thread's copy groups are in flight
template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned addr, unsigned (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// d = a b, and d += a b, for one bf16 step: a 16 x 16, b 16 x 8
// (ldmatrix fragments)
__device__ __forceinline__ void mma_bf16_0(float (&d)[4],
                                           const unsigned (&a)[4],
                                           unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b, and d += a b, for one TF32 step: a 16 x 8, b 8 x 8
__device__ __forceinline__ void mma_tf32_0(float (&d)[4],
                                           const unsigned (&a)[4],
                                           unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned tf32(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// An MMA step's operands, ready for the tensor cores: the raw fragment
// registers in bf16; their TF32 hi and lo parts in f32.
template <typename T>
struct FragA {
  unsigned r[4];
};
template <>
struct FragA<float> {
  unsigned hi[4], lo[4];
};
template <typename T>
struct FragB {
  unsigned r0, r1;
};
template <>
struct FragB<float> {
  unsigned hi0, hi1, lo0, lo1;
};

__device__ __forceinline__ void split(unsigned v, unsigned& hi,
                                      unsigned& lo) {
  const float f = __uint_as_float(v);
  hi = tf32(f);
  lo = tf32(f - __uint_as_float(hi));
}

template <typename T>
__device__ __forceinline__ FragA<T> frag_a(const unsigned (&r)[4]) {
  FragA<T> f;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f.r[i] = r[i];
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(r[i], f.hi[i], f.lo[i]);
  }
  return f;
}

template <typename T>
__device__ __forceinline__ FragB<T> frag_b(unsigned r0, unsigned r1) {
  FragB<T> f;
  if constexpr (sizeof(T) == 2) {
    f.r0 = r0;
    f.r1 = r1;
  } else {
    split(r0, f.hi0, f.lo0);
    split(r1, f.hi1, f.lo1);
  }
  return f;
}

// d += a b over one MMA step (mma1), or a0 b0 + a1 b1 over two (mma2;
// KSPAN bytes of depth): bf16 MMAs, or 3xTF32 (the small terms first),
// into a partial that starts at 0 and joins d by an f32 add. The tensor
// cores add into their accumulator with truncation, so a chain of MMAs
// into d drifts toward zero by up to an ulp of d a step: f32's dw missed
// its bound by 4.9x at the wide shape, and bf16's z rounded to the other
// side of the plain version's often enough to move the wide model's
// step-locked momentum past its bound (chip_smoke.py phase 14). The
// partial keeps the truncations to ulps of one or two steps' sum, and the
// sum over partials rounds to nearest, as the plain version's does. The
// conv body sums two steps a partial where registers allow (fewer adds);
// dw one (its 72 accumulators leave none for a second step's fragments).
template <typename T>
__device__ __forceinline__ void mma_step(float (&p)[4], const FragA<T>& a,
                                         const FragB<T>& b, bool first) {
  if constexpr (sizeof(T) == 2) {
    if (first)
      mma_bf16_0(p, a.r, b.r0, b.r1);
    else
      mma_bf16(p, a.r, b.r0, b.r1);
  } else {
    if (first)
      mma_tf32_0(p, a.lo, b.hi0, b.hi1);
    else
      mma_tf32(p, a.lo, b.hi0, b.hi1);
    mma_tf32(p, a.hi, b.lo0, b.lo1);
    mma_tf32(p, a.hi, b.hi0, b.hi1);
  }
}

template <typename T>
__device__ __forceinline__ void mma1(float (&d)[4], const FragA<T>& a,
                                     const FragB<T>& b) {
  float p[4];
  mma_step<T>(p, a, b, true);
#pragma unroll
  for (int q = 0; q < 4; ++q) d[q] += p[q];
}

template <typename T>
__device__ __forceinline__ void mma2(float (&d)[4], const FragA<T>& a0,
                                     const FragB<T>& b0, const FragA<T>& a1,
                                     const FragB<T>& b1) {
  float p[4];
  mma_step<T>(p, a0, b0, true);
  mma_step<T>(p, a1, b1, false);
#pragma unroll
  for (int q = 0; q < 4; ++q) d[q] += p[q];
}

// NCHW in (B, K, S, S) -> channel-last out (B, S + 2P, S + 2P, Kp): zeros
// in the P-pixel halo and in channels K .. Kp - 1 (Kp a multiple of 64
// bytes). A 32-pixel x 64-channel tile a block, through shared memory:
// each thread loads its 8 elements (lanes along a channel's pixels) before
// it stores any, then each pixel's channels leave in 16-byte stores.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    k_to_cl(const T* __restrict__ in, T* __restrict__ out, int K, int S,
            int P, int Kp) {
  constexpr int EG = 16 / sizeof(T);   // channels a 16-byte group
  __shared__ __align__(16) T tile[32][64 + EG];
  const int Sp = S + 2 * P, npix = Sp * Sp;
  const int p0 = blockIdx.x * 32, k0 = blockIdx.y * 64, b = blockIdx.z;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int pix = p0 + tx, Y = pix / Sp, X = pix - Y * Sp;
  const int y = Y - P, xx = X - P;
  const bool inside = pix < npix && y >= 0 && y < S && xx >= 0 && xx < S;
  const T* src =
      in + ((size_t)b * K + k0) * S * S + (inside ? y * S + xx : 0);
  T v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kk = ty + 8 * i;
    v[i] = inside && k0 + kk < K ? src[(size_t)kk * S * S] : from_f<T>(0.0f);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) tile[tx][ty + 8 * i] = v[i];
  __syncthreads();
  for (int e = threadIdx.x; e < 32 * (64 / EG); e += THREADS) {
    const int pp = e / (64 / EG), k = k0 + (e % (64 / EG)) * EG;
    if (p0 + pp < npix && k < Kp)
      *(uint4*)(out + ((size_t)b * npix + p0 + pp) * Kp + k) =
          *(const uint4*)&tile[pp][k - k0];
  }
}

// w (M, C, 3, 3) -> the conv body's weight table wt (9, Np, Kp): the
// forward's wt[tap][m][c] = w[m, c, tap]; dx's (flip) wt[tap][c][m] =
// w[m, c, 8 - tap]; zeros past the valid rows and channels.
template <typename T>
__global__ void k_wprep(const T* __restrict__ w, T* __restrict__ wt, int M,
                        int C, int Np, int Kp, int flip) {
  const long long n = 9LL * Np * Kp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(i % Kp), r = (int)((i / Kp) % Np);
    const int tap = (int)(i / ((long long)Kp * Np));
    float v = 0.0f;
    if (!flip && r < M && k < C)
      v = to_f(w[((size_t)r * C + k) * 9 + tap]);
    if (flip && r < C && k < M)
      v = to_f(w[((size_t)k * C + r) * 9 + 8 - tap]);
    wt[i] = from_f<T>(v);
  }
}

struct ConvArgs {
  int Hs, Ho;    // side of the staged input and of the output (Hs - 2)
  int Kp;        // input channels as stored (KSPAN bytes a partial)
  int N, Np;     // output channels, and as the weight table pads them
  int R, Wo;     // a strip: output rows x columns (R * Wo <= conv_bm)
  int strips_c;  // strips across a row
};

// out[b, n, :, :] of one strip of one image for BN output channels:
// GEMM rows the strip's pixels, columns n, depth (chunk, tap, channel).
// 8 warps: BMT / 32 down the pixels (32 each, two m16 tiles), the rest
// across the channels. Shared memory: the strip's stage (two where there
// are two chunks or more and the tile is 128 pixels), then a ring of three
// weight tiles; the tile of step it + 2, and the stage of the chunk it
// starts, load while step it computes (a single stage loads at its
// chunk's first step).
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
    k_conv(const T* __restrict__ in, const T* __restrict__ wt,
           T* __restrict__ out, const ConvArgs a) {
  constexpr int BMT = conv_bm(BN), WMW = BMT / 32, WNW = 8 / WMW;
  constexpr int WN = BN / 8 / WNW;   // n8 tiles a warp
  constexpr int ES = sizeof(T);
  // MMA steps a partial: two, but one for f32 at BN 128, whose 64
  // accumulators and split fragments leave no registers for a second
  constexpr int HS = ES == 2 || BN <= 64 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Ws = a.Wo + 2, spix = (a.R + 2) * Ws;
  const int kbytes = a.Kp * ES;
  const int chunks = (kbytes + CHUNK - 1) / CHUNK, iters = 9 * chunks;
  const int nst = chunks > 1 && BMT == 128 ? 2 : 1;
  unsigned char* const stage0 = smem;
  unsigned char* const w0 = smem + nst * spix * PITCH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WMW, wn = warp / WMW;
  const int b = blockIdx.z, n0 = blockIdx.y * BN;
  const int sr = blockIdx.x / a.strips_c, sc = blockIdx.x - sr * a.strips_c;
  const int oy0 = sr * a.R, ox0 = sc * a.Wo;
  const int rows = min(a.R, a.Ho - oy0), cols = min(a.Wo, a.Ho - ox0);
  const unsigned char* inb =
      (const unsigned char*)(in + (size_t)b * a.Hs * a.Hs * a.Kp);
  const unsigned char* wtb = (const unsigned char*)(wt + (size_t)n0 * a.Kp);

  // this lane's A rows (ldmatrix x4: row lane % 16, 16-byte half lane / 16):
  // the staged pixel of tap (0, 0), pixel 0 past the strip (not stored)
  int arow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wm * 32 + i * 16 + (lane & 15);
    const int ry = r / a.Wo, rx = r - ry * a.Wo;
    arow[i] = (ry < rows && rx < cols) ? ry * Ws + rx : 0;
  }
  const int acol = (lane >> 4) * 16;
  // B rows (x4 over two n8 tiles): n = lane % 8 + 8 (lane / 16), 16-byte
  // half (lane / 8) % 2
  const int brow = wn * (BN / WNW) + (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 16;

  auto load_stage = [&](int chunk) {
    unsigned char* dst = stage0 + (chunk % nst) * spix * PITCH;
    const int cb = chunk * CHUNK, nb = min(CHUNK, kbytes - cb);
    for (int e = tid; e < spix * (CHUNK / 16); e += THREADS) {
      const int p = e / (CHUNK / 16), g = e % (CHUNK / 16);
      const int py = p / Ws, px = p - py * Ws;
      const int iy = oy0 + py, ix = ox0 + px;
      if (g * 16 < nb && iy < a.Hs && ix < a.Hs)
        cp16(smem_u32(dst + p * PITCH + g * 16),
             inb + ((size_t)iy * a.Hs + ix) * kbytes + cb + g * 16);
    }
  };
  auto load_w = [&](int it) {
    unsigned char* dst = w0 + (it % 3) * BN * PITCH;
    const int chunk = it / 9, tap = it - chunk * 9;
    const int cb = chunk * CHUNK, nb = min(CHUNK, kbytes - cb);
    const unsigned char* src = wtb + (size_t)tap * a.Np * kbytes + cb;
    for (int e = tid; e < BN * (CHUNK / 16); e += THREADS) {
      const int n = e / (CHUNK / 16), g = e % (CHUNK / 16);
      if (g * 16 < nb)
        cp16(smem_u32(dst + n * PITCH + g * 16),
             src + (size_t)n * kbytes + g * 16);
    }
  };

  float acc[2][WN][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  // one copy group a step: group it holds the weight tile of step it + 2
  // and, with two stages, where that step starts a chunk, the chunk's
  // stage (its buffer was last read two chunks back)
  load_stage(0);
  load_w(0);
  cp_commit();
  load_w(1);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const int chunk = it / 9, tap = it - chunk * 9;
    if (nst == 1 && tap == 0 && chunk > 0) {
      // the last step ended on a barrier: every warp is done with the stage
      load_stage(chunk);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
    }
    if (it + 2 < iters) {
      load_w(it + 2);
      if (nst == 2 && (it + 2) % 9 == 0) load_stage((it + 2) / 9);
    }
    cp_commit();
    const int off = (tap / 3) * Ws + tap % 3;
    const int steps = min(CHUNK, kbytes - chunk * CHUNK) / KSTEP;
    const unsigned sa = smem_u32(stage0 + (chunk % nst) * spix * PITCH);
    const unsigned sb = smem_u32(w0 + (it % 3) * BN * PITCH);
    // steps is even (channels pad to KSPAN bytes); HS of them a partial
#pragma unroll
    for (int ks = 0; ks < CHUNK / KSTEP; ks += HS) {
      if (ks < steps) {
        FragA<T> fa[HS][2];   // [step][m16 tile]
#pragma unroll
        for (int h = 0; h < HS; ++h)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            unsigned r[4];
            ldsm_x4(sa + (arow[i] + off) * PITCH + (ks + h) * KSTEP + acol,
                    r);
            fa[h][i] = frag_a<T>(r);
          }
#pragma unroll
        for (int j = 0; j < WN; j += 2) {
          FragB<T> fb[HS][2];   // [step][n8 tile]
#pragma unroll
          for (int h = 0; h < HS; ++h) {
            unsigned r[4];
            ldsm_x4(sb + (brow + j * 8) * PITCH + (ks + h) * KSTEP + bcol, r);
            fb[h][0] = frag_b<T>(r[0], r[1]);
            fb[h][1] = frag_b<T>(r[2], r[3]);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              if constexpr (HS == 2)
                mma2<T>(acc[i][j + jj], fa[0][i], fb[0][jj], fa[1][i],
                        fb[1][jj]);
              else
                mma1<T>(acc[i][j + jj], fa[0][i], fb[0][jj]);
            }
        }
      }
    }
    cp_wait<1>();
    __syncthreads();
  }

  // the sums, rounded once, through shared memory as [n][pixel] (the
  // stages are free: the loop ended on a barrier), then each map's
  // pixels to out
  constexpr int OP = BMT + 16 / ES;
  T* ot = (T*)smem;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      const int r = wm * 32 + i * 16 + g;
      const int n = wn * (BN / WNW) + j * 8 + 2 * t4;
      ot[n * OP + r] = from_f<T>(acc[i][j][0]);
      ot[(n + 1) * OP + r] = from_f<T>(acc[i][j][1]);
      ot[n * OP + r + 8] = from_f<T>(acc[i][j][2]);
      ot[(n + 1) * OP + r + 8] = from_f<T>(acc[i][j][3]);
    }
  __syncthreads();
  // a strip of whole rows is one run of each map's pixels
  const int npix = rows * a.Wo;
  for (int n = warp; n < BN && n0 + n < a.N; n += THREADS / 32) {
    T* dst = out + ((size_t)b * a.N + n0 + n) * a.Ho * a.Ho + oy0 * a.Ho +
             ox0;
    const T* src = ot + n * OP;
    if (cols == a.Ho) {
      for (int r = lane; r < npix; r += 32) dst[r] = src[r];
    } else {
      for (int r = lane; r < npix; r += 32) {
        const int ry = r / a.Wo, rx = r - ry * a.Wo;
        if (rx < cols) dst[ry * a.Ho + rx] = src[r];
      }
    }
  }
}

struct WgArgs {
  int H, O;        // x side, dz side
  int Cp, Mp;      // channels of the channel-last x and padded dz
  int C, M, Cq;    // Cq: channel stride of a slice
  int R, Wo, strips_c, strips;  // strips of at most BM pixels
  int units, per_slice;         // B * strips, units a slice
};

// part[s, m, tap, c] = the dw of WG_M maps x WG_C channels x 9 taps summed
// over slice s's (image, strip) units in order: GEMM rows m, columns (tap,
// c), depth the strip's output pixels. 8 warps: 2 down the maps (32 each),
// 4 across the channels (8 each, every tap). Two stage sets (dz and x of
// one unit each): unit u + 1 loads by cp.async while unit u computes.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    k_wgrad(const T* __restrict__ xcl, const T* __restrict__ dzp,
            float* __restrict__ part, const WgArgs a) {
  constexpr int ES = sizeof(T), KS = KSTEP / ES;   // pixels an MMA step
  constexpr int DZP = Elem<T>::DZ_PITCH, XP = Elem<T>::X_PITCH;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Ws = a.Wo + 2, spix = (a.R + 2) * Ws;
  unsigned char* const dz0 = smem;
  unsigned char* const x0 = smem + 2 * BM * DZP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wc = warp >> 1;
  const int s = blockIdx.x, c0 = blockIdx.y * WG_C, m0 = blockIdx.z * WG_M;
  const int u0 = s * a.per_slice, u1 = min(a.units, u0 + a.per_slice);
  const int Hd = a.H + 2;
  const int mbytes = min(WG_M, a.Mp - m0) * ES;
  const int cbytes = min(WG_C, a.Cp - c0) * ES;

  struct Unit {
    int b, oy0, ox0, rows, cols;
  };
  auto unit = [&](int u) {
    Unit t;
    t.b = u / a.strips;
    const int st = u - t.b * a.strips, sr = st / a.strips_c;
    t.oy0 = sr * a.R;
    t.ox0 = (st - sr * a.strips_c) * a.Wo;
    t.rows = min(a.R, a.O - t.oy0);
    t.cols = min(a.Wo, a.O - t.ox0);
    return t;
  };
  // dz rows j = ry * Wo + rx of the strip (zeros past it, to a whole MMA
  // step), maps m0..; x the strip's input pixels with the halo, channels
  // c0..
  auto load = [&](const Unit& t, int q) {
    const int nj = (t.rows * a.Wo + KS - 1) / KS * KS;
    unsigned char* dzs = dz0 + q * BM * DZP;
    const unsigned char* dzb = (const unsigned char*)(
        dzp + (size_t)t.b * Hd * Hd * a.Mp + m0);
    for (int e = tid; e < nj * (DZP / 16); e += THREADS) {
      const int j = e / (DZP / 16), g = e % (DZP / 16);
      const int ry = j / a.Wo, rx = j - ry * a.Wo;
      unsigned char* dst = dzs + j * DZP + g * 16;
      if (ry < t.rows && rx < t.cols) {
        if (g * 16 < mbytes)
          cp16(smem_u32(dst),
               dzb + ((size_t)(t.oy0 + ry + 2) * Hd + t.ox0 + rx + 2) * a.Mp *
                         ES + g * 16);
      } else {
        *(uint4*)dst = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    unsigned char* xs = x0 + q * spix * XP;
    const unsigned char* xb = (const unsigned char*)(
        xcl + (size_t)t.b * a.H * a.H * a.Cp + c0);
    for (int e = tid; e < spix * (XP / 16); e += THREADS) {
      const int p = e / (XP / 16), g = e % (XP / 16);
      const int py = p / Ws, px = p - py * Ws;
      const int iy = t.oy0 + py, ix = t.ox0 + px;
      if (g * 16 < cbytes && iy < a.H && ix < a.H)
        cp16(smem_u32(xs + p * XP + g * 16),
             xb + ((size_t)iy * a.H + ix) * a.Cp * ES + g * 16);
    }
  };
  // the staged x pixel of tap (0, 0) for strip pixel j; pixel 0 past the
  // strip (its dz row is zero)
  auto xrow = [&](const Unit& t, int j) {
    const int ry = j / a.Wo, rx = j - ry * a.Wo;
    return (ry < t.rows && rx < t.cols) ? ry * Ws + rx : 0;
  };

  float acc[2][9][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][tap][q] = 0.0f;

  load(unit(u0), 0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  const int g = lane >> 2, t4 = lane & 3;
  for (int u = u0; u < u1; ++u) {
    // the other set was last read by unit u - 1, before the barrier
    const int q = (u - u0) & 1;
    if (u + 1 < u1) load(unit(u + 1), q ^ 1);
    cp_commit();
    const Unit cur = unit(u);
    const int steps = (cur.rows * a.Wo + KS - 1) / KS;
    const unsigned char* dzs = dz0 + q * BM * DZP;
    const unsigned char* xs = x0 + q * spix * XP;
    for (int ks = 0; ks < steps; ++ks) {
      if constexpr (ES == 2) {
        // A = dz^T (rows m, depth pixels) by ldmatrix.trans of the [pixel]
        // [m] stage; B = x of each tap (depth pixels, columns c) the same
        const int mat = lane >> 3;
        const int krow = ks * 16 + (lane & 7) + (mat >> 1) * 8;
        FragA<T> fa[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          unsigned r[4];
          ldsm_x4_t(smem_u32(dzs + krow * DZP +
                             (wm * 32 + i * 16 + (mat & 1) * 8) * ES),
                    r);
          fa[i] = frag_a<T>(r);
        }
        // taps in pairs: lanes 16-31 address the pair's second tap
        const int xr = xrow(cur, ks * 16 + (lane & 7) + (mat & 1) * 8);
        const unsigned xa = smem_u32(xs + xr * XP + wc * 8 * ES);
        const int second = lane >> 4;
#pragma unroll
        for (int tap = 0; tap < 8; tap += 2) {
          const int t = tap + second;
          unsigned r[4];
          ldsm_x4_t(xa + ((t / 3) * Ws + t % 3) * XP, r);
          const FragB<T> f0 = frag_b<T>(r[0], r[1]);
          const FragB<T> f1 = frag_b<T>(r[2], r[3]);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma1<T>(acc[i][tap], fa[i], f0);
            mma1<T>(acc[i][tap + 1], fa[i], f1);
          }
        }
        unsigned r[2];
        ldsm_x2_t(xa + (2 * Ws + 2) * XP, r);
        const FragB<T> f8 = frag_b<T>(r[0], r[1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma1<T>(acc[i][8], fa[i], f8);
      } else {
        // f32: fragments by 32-bit shared loads (ldmatrix transposes
        // 16-bit elements only). a = A[g | g+8][t4 | t4+4], b = B[t4 |
        // t4+4][g].
        const int k0 = ks * 8 + t4, k1 = k0 + 4;
        const float* d0 = (const float*)(dzs + k0 * DZP);
        const float* d1 = (const float*)(dzs + k1 * DZP);
        FragA<T> fa[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = wm * 32 + i * 16 + g;
          const unsigned r[4] = {__float_as_uint(d0[m]),
                                 __float_as_uint(d0[m + 8]),
                                 __float_as_uint(d1[m]),
                                 __float_as_uint(d1[m + 8])};
          fa[i] = frag_a<T>(r);
        }
        const float* xa0 =
            (const float*)(xs + xrow(cur, k0) * XP) + wc * 8 + g;
        const float* xa1 =
            (const float*)(xs + xrow(cur, k1) * XP) + wc * 8 + g;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int off = ((tap / 3) * Ws + tap % 3) * (XP / 4);
          const FragB<T> fb = frag_b<T>(__float_as_uint(xa0[off]),
                                        __float_as_uint(xa1[off]));
#pragma unroll
          for (int i = 0; i < 2; ++i) mma1<T>(acc[i][tap], fa[i], fb);
        }
      }
    }
    cp_wait<0>();
    __syncthreads();
  }

  const int c = c0 + wc * 8 + 2 * t4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + wm * 32 + i * 16 + g;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      float* dst = part + (((size_t)s * a.M + m) * 9 + tap) * a.Cq + c;
      if (m < a.M)
        *(float2*)dst = make_float2(acc[i][tap][0], acc[i][tap][1]);
      if (m + 8 < a.M)
        *(float2*)(dst + (size_t)8 * 9 * a.Cq) =
            make_float2(acc[i][tap][2], acc[i][tap][3]);
    }
  }
}

// dw[m, c, tap] = the sum of part[s, m, tap, c] over the slices s in
// order, rounded once to the weight type.
template <typename T>
__global__ void k_dw_reduce(const float* __restrict__ part, T* __restrict__ dw,
                            int S, int M, int C, int Cq) {
  const int n = M * 9 * C;
  const size_t stride = (size_t)M * 9 * Cq;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int mt = i / C, c = i - mt * C, m = mt / 9, tap = mt - m * 9;
    const float* p = part + (size_t)mt * Cq + c;
    float s = 0.0f;
    for (int z = 0; z < S; ++z) s += p[z * stride];
    dw[((size_t)m * C + c) * 9 + tap] = from_f<T>(s);
  }
}

int blocks_for(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return (int)(b < 8192 ? (b < 1 ? 1 : b) : 8192);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// shared bytes of a conv pass over kbytes of input channels a pixel (as
// ops/conv3x3.py's _conv_pass)
int conv_smem(int R, int Wo, int BN, int es, int kbytes) {
  const int nst = kbytes > CHUNK && conv_bm(BN) == 128 ? 2 : 1;
  const int pipe = nst * (R + 2) * (Wo + 2) * PITCH + 3 * BN * PITCH;
  const int epi = BN * (conv_bm(BN) + 16 / es) * es;
  return pipe > epi ? pipe : epi;
}

// whether a conv pass of the plan is one the kernel runs: input side, in
// and out channels K, N
bool bad_pass(const int* p, int side, int K, int N, int es) {
  const int bn = p[PF_BN];
  return (bn != 32 && bn != 64 && bn != 128) || p[PF_KP] < K ||
         (p[PF_KP] * es) % KSPAN || p[PF_NP] < N || p[PF_NP] % bn ||
         p[PF_NP] / bn > 65535 || p[PF_R] < 1 || p[PF_WO] < 1 ||
         p[PF_R] * p[PF_WO] > conv_bm(bn) || p[PF_R] > side - 2 ||
         p[PF_WO] > side - 2 ||
         p[PF_SMEM] != conv_smem(p[PF_R], p[PF_WO], bn, es, p[PF_KP] * es) ||
         p[PF_SMEM] > SMEM_OPT_IN;
}

template <typename T, int BN>
cudaError_t launch_conv(const T* in, const T* wt, T* out, int B,
                        const ConvArgs& a, int strips, int smem,
                        cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      k_conv<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  k_conv<T, BN><<<dim3(strips, a.Np / BN, B), THREADS, smem, s>>>(in, wt,
                                                                  out, a);
  return cudaGetLastError();
}

// one conv pass p (a plan's 6 integers): in (B, side, side, Kp)
// channel-last, wt (9, Np, Kp) -> out (B, N, side - 2, side - 2)
template <typename T>
cudaError_t conv_pass(const T* in, const T* wt, T* out, int B, int side,
                      int N, const int* p, cudaStream_t s) {
  ConvArgs a;
  a.Hs = side;
  a.Ho = side - 2;
  a.Kp = p[PF_KP];
  a.N = N;
  a.Np = p[PF_NP];
  a.R = p[PF_R];
  a.Wo = p[PF_WO];
  a.strips_c = ceil_div(a.Ho, a.Wo);
  const int strips = ceil_div(a.Ho, a.R) * a.strips_c;
  switch (p[PF_BN]) {
    case 32:
      return launch_conv<T, 32>(in, wt, out, B, a, strips, p[PF_SMEM], s);
    case 64:
      return launch_conv<T, 64>(in, wt, out, B, a, strips, p[PF_SMEM], s);
    default:
      return launch_conv<T, 128>(in, wt, out, B, a, strips, p[PF_SMEM], s);
  }
}

// NCHW (B, K, S, S) -> channel-last (B, S + 2P, S + 2P, Kp)
template <typename T>
cudaError_t to_cl(const T* in, T* out, int B, int K, int S, int P, int Kp,
                  cudaStream_t s) {
  const int side = S + 2 * P;
  k_to_cl<T><<<dim3(ceil_div(side * side, 32), ceil_div(Kp, 64), B), THREADS,
               0, s>>>(in, out, K, S, P, Kp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t wprep(const T* w, T* wt, int M, int C, const int* p, int flip,
                  cudaStream_t s) {
  k_wprep<T><<<blocks_for(9LL * p[PF_NP] * p[PF_KP]), THREADS, 0, s>>>(
      w, wt, M, C, p[PF_NP], p[PF_KP], flip);
  return cudaGetLastError();
}

#define CHECK(call)                      \
  do {                                   \
    const cudaError_t e_ = (call);       \
    if (e_ != cudaSuccess) return e_;    \
  } while (0)

template <typename T>
cudaError_t forward(const T* x, const T* w, T* out, T* wt, T* xcl, int B,
                    int C, int H, int M, const int* plan, cudaStream_t s) {
  CHECK(wprep<T>(w, wt, M, C, plan + PF_KP, 0, s));
  CHECK(to_cl<T>(x, xcl, B, C, H, 0, plan[PF_KP], s));
  return conv_pass<T>(xcl, wt, out, B, H, M, plan + PF_KP, s);
}

template <typename T>
cudaError_t backward(const T* x, const T* w, const T* dz, T* dx, T* dw,
                     T* wt, T* dzcl, T* xcl, float* part, int B, int C, int H,
                     int M, const int* plan, cudaStream_t s) {
  const int O = H - 2;
  // dx: the conv body over dz with a zero halo of 2, flipped taps
  CHECK(wprep<T>(w, wt, M, C, plan + PD_KP, 1, s));
  CHECK(to_cl<T>(dz, dzcl, B, M, O, 2, plan[PD_KP], s));
  CHECK(conv_pass<T>(dzcl, wt, dx, B, H + 2, C, plan + PD_KP, s));
  // dw: slices over strips of at most BM pixels, then their sum in order
  CHECK(to_cl<T>(x, xcl, B, C, H, 0, plan[PF_KP], s));
  WgArgs a;
  a.H = H;
  a.O = O;
  a.Cp = plan[PF_KP];
  a.Mp = plan[PD_KP];
  a.C = C;
  a.M = M;
  a.Cq = plan[PW_CQ];
  a.R = plan[PW_R];
  a.Wo = plan[PW_WO];
  a.strips_c = ceil_div(O, a.Wo);
  a.strips = ceil_div(O, a.R) * a.strips_c;
  a.units = B * a.strips;
  a.per_slice = plan[PW_PER_SLICE];
  const int S = plan[PW_SLICES], smem = plan[PW_SMEM];
  CHECK(cudaFuncSetAttribute(
      k_wgrad<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  k_wgrad<T><<<dim3(S, ceil_div(C, WG_C), ceil_div(M, WG_M)), THREADS, smem,
               s>>>(xcl, dzcl, part, a);
  CHECK(cudaGetLastError());
  k_dw_reduce<T><<<blocks_for((long long)M * 9 * C), THREADS, 0, s>>>(
      part, dw, S, M, C, a.Cq);
  return cudaGetLastError();
}

bool bad_shape(int B, int C, int H, int M) {
  return B < 1 || C < 1 || M < 1 || H < 3 || B > 65535;
}

// whether the plan is one the kernels run for these shapes
bool bad_plan(int B, int C, int H, int M, int es, const int* plan) {
  if (bad_pass(plan + PF_KP, H, C, M, es) ||
      bad_pass(plan + PD_KP, H + 2, M, C, es))
    return true;
  const int O = H - 2, R = plan[PW_R], Wo = plan[PW_WO];
  const long long units =
      (long long)B * ceil_div(O, R) * ceil_div(O, Wo);
  const int per = plan[PW_PER_SLICE], S = plan[PW_SLICES];
  const int dzp = es == 2 ? Elem<__nv_bfloat16>::DZ_PITCH
                          : Elem<float>::DZ_PITCH;
  const int xp = es == 2 ? Elem<__nv_bfloat16>::X_PITCH : Elem<float>::X_PITCH;
  const int smem = 2 * (BM * dzp + (R + 2) * (Wo + 2) * xp);
  return R < 1 || Wo < 1 || R * Wo > BM || R > O || Wo > O || per < 1 ||
         units > 0x7fffffffLL ||
         (long long)S * per < units || (long long)(S - 1) * per >= units ||
         plan[PW_CQ] < C || plan[PW_CQ] % WG_C ||
         ceil_div(C, WG_C) > 65535 || ceil_div(M, WG_M) > 65535 ||
         plan[PW_SMEM] != smem || smem > SMEM_OPT_IN;
}

}  // namespace

extern "C" {

const char* conv3x3_error_string(int code) {
  if (code == -1) return "shape out of the kernel's range (B in [1, 65535], "
                         "C, M >= 1, H >= 3)";
  if (code == -2) return "the tiling plan does not fit these shapes or the "
                         "kernel's constants (ops/conv3x3.py conv3x3_plan)";
  return cudaGetErrorString((cudaError_t)code);
}

// x (B, C, H, H), w (M, C, 3, 3), out (B, M, H-2, H-2), contiguous, all f32
// (bf16 == 0) or all bf16; plan: conv3x3_plan's N_PLAN integers; scratch
// in the operand type: wt (9, Np, Kp) of the forward's pass and xcl (B, H,
// H, Kp). Launches on ``stream`` of ``device``; returns 0 or the CUDA
// error of a launch.
int conv3x3_forward(const void* x, const void* w, void* out, void* wt,
                    void* xcl, int B, int C, int H, int M, int bf16,
                    const int* plan, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (bad_shape(B, C, H, M)) return -1;
  if (bad_plan(B, C, H, M, bf16 ? 2 : 4, plan)) return -2;
  cudaStream_t s = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf;
  e = bf16 ? forward<bf>((const bf*)x, (const bf*)w, (bf*)out, (bf*)wt,
                         (bf*)xcl, B, C, H, M, plan, s)
           : forward<float>((const float*)x, (const float*)w, (float*)out,
                            (float*)wt, (float*)xcl, B, C, H, M, plan, s);
  return (int)e;
}

// dz (B, M, H-2, H-2) -> dx (x's shape and type), dw (w's shape and type).
// Scratch: in the operand type wt (9, Np, Kp) of dx's pass, dzcl (B, H+2,
// H+2, Mp) and xcl (B, H, H, Cp); part (slices, M, 9, Cq) f32.
int conv3x3_backward(const void* x, const void* w, const void* dz, void* dx,
                     void* dw, void* wt, void* dzcl, void* xcl, void* part,
                     int B, int C, int H, int M, int bf16, const int* plan,
                     int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (bad_shape(B, C, H, M)) return -1;
  if (bad_plan(B, C, H, M, bf16 ? 2 : 4, plan)) return -2;
  cudaStream_t s = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf;
  e = bf16 ? backward<bf>((const bf*)x, (const bf*)w, (const bf*)dz, (bf*)dx,
                          (bf*)dw, (bf*)wt, (bf*)dzcl, (bf*)xcl,
                          (float*)part, B, C, H, M, plan, s)
           : backward<float>((const float*)x, (const float*)w,
                             (const float*)dz, (float*)dx, (float*)dw,
                             (float*)wt, (float*)dzcl, (float*)xcl,
                             (float*)part, B, C, H, M, plan, s);
  return (int)e;
}

}  // extern "C"

// Probe kernels for Hopper (sm_90a): the port of the three Pallas probes of
// the JAX package's tools.
//
//   k_floor          replaces tools/floor_probe.py::make_probe (its
//                    pallas_call at :95): per step, every input block of the
//                    step is staged whole into shared memory (the traffic the
//                    TPU grid's DMA carries), and the f32 sum of the blocks
//                    (of each block's first row when a block holds U > 1
//                    steps), int32 words summed as integers, is stored as one
//                    output row of W copies. One launch an epoch (a block
//                    holds U steps), or one launch a U steps.
//   k_sec_* (two     replace tools/conv_layout_probe.py::make_section (its
//   layouts)         pallas_call at :215), the 'striped' variant's function:
//                    the flagship's conv2 section, forward and backward, on
//                    an input made in the kernel from the step's (8, 128)
//                    block. The TPU variants are lane-slot layouts of one
//                    function; the card's are a thread per output over
//                    device-memory planes (7 launches a step, the fused
//                    kernels' stage form) and a block per step holding one
//                    sample's planes in shared memory (one launch an epoch).
//   k_relay          replaces tools/conv_layout_probe.py::make_relay (its
//                    pallas_call at :255): the (20, 784) batch copied into
//                    G-row blocks of g shared-memory slots of 896 floats,
//                    and the sum of what is read back.
//
// Plain PyTorch versions: theanet_tpu_torch/tools/floor_probe.py
// (floor_reference) and theanet_tpu_torch/tools/conv_layout_probe.py
// (section_reference, relay_reference).
//
// What bounds them. k_floor and k_relay move bytes and add: device memory
// and the per-launch or per-block floor bound them. The section does ~7.3 M
// multiply-adds a step on 169-position planes; a step is a few thousand
// threads' work, so a launch a stage is bound by launch latency, and a block
// a step by its SM's issue rate. The designs are the simplest right ones: a
// fixed summation order in every reduction (sums of a block in int64 or
// double, rounded once to f32), so each kernel is held to its plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#define CHECK(expr)                        \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

namespace {

constexpr int T = 256;             // threads a block
constexpr int MAX_IN = 8;          // input streams of a floor variant
constexpr size_t SMEM_OPT_IN = 227 * 1024;

template <typename K>
bool smem_opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return true;
  if (bytes > SMEM_OPT_IN) return false;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes) == cudaSuccess;
}

// Sum over the block of one value a thread; every thread gets the sum.
// ``red`` holds 32 values.
template <typename V>
__device__ V block_sum(V v, V* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  V t = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  return t;
}

// ------------------------------------------------------------------ floor

struct FloorIn {
  const float* p[MAX_IN];   // (n_steps, elems) each; int32 words as floats
  long long elems[MAX_IN];  // words of one step's block
  int cols[MAX_IN];         // words of its first row
  int isint[MAX_IN];
  int n;
};

// Block ``blockIdx.x`` of a launch at ``it0`` holds steps (it0 + blockIdx.x)
// * U + u, u < U. Dynamic shared memory: the largest block, staged whole.
__global__ void k_floor(FloorIn in, long long it0, int U, int W,
                        float* __restrict__ out) {
  extern __shared__ float stage[];
  __shared__ double redd[32];
  __shared__ long long redl[32];
  const int tid = threadIdx.x;
  for (int u = 0; u < U; ++u) {
    const long long s = (it0 + blockIdx.x) * U + u;
    float acc = 0.0f;
    for (int i = 0; i < in.n; ++i) {
      const long long n = in.elems[i];
      const float* src = in.p[i] + s * n;
      if ((n & 3) == 0) {
        const float4* s4 = reinterpret_cast<const float4*>(src);
        float4* d4 = reinterpret_cast<float4*>(stage);
        for (long long e = tid; e < n / 4; e += blockDim.x) d4[e] = s4[e];
      } else {
        for (long long e = tid; e < n; e += blockDim.x) stage[e] = src[e];
      }
      __syncthreads();
      const long long m = U == 1 ? n : in.cols[i];
      float v;
      if (in.isint[i]) {
        long long t = 0;
        for (long long e = tid; e < m; e += blockDim.x)
          t += __float_as_int(stage[e]);
        v = (float)block_sum(t, redl);
      } else {
        double t = 0.0;
        for (long long e = tid; e < m; e += blockDim.x) t += stage[e];
        v = (float)block_sum(t, redd);
      }
      acc = __fadd_rn(acc, v);
      __syncthreads();   // the next block overwrites the stage
    }
    for (int j = tid; j < W; j += blockDim.x) out[s * W + j] = acc;
  }
}

// ------------------------------------------------------------ conv section

// the flagship's conv2 geometry (conv_layout_probe.py:47-53)
constexpr int M1 = 4, M2 = 20, B = 20, P1 = 13, PQ = P1 * P1, F = 3,
              NT = F * F, C2 = P1 - F + 1, P2 = (C2 + 1) / 2, P2Q = P2 * P2,
              NW = M2 * NT * M1;
constexpr float BIG_NEG = -1e30f, SLOPE = 0.05f;

// tap k = u*F + v reads input q + off(k), circularly (pltpu.roll)
__device__ __forceinline__ int tap_off(int k) {
  return (F - 1 - k / F) * P1 + (F - 1 - k % F);
}

__device__ __forceinline__ int wrap(int q) { return q >= PQ ? q - PQ : q; }

// conv2 output q of map m2 for one sample, its input planes p1(m1, q') at
// p1[m1 * pstride + q']; weights w (M2, NT*M1) indexed [m2][k*M1 + m1].
__device__ __forceinline__ float sec_z(const float* __restrict__ w,
                                       const float* __restrict__ b2,
                                       const float* p1, int pstride, int m2,
                                       int q) {
  float acc = 0.0f;
  for (int k = 0; k < NT; ++k) {
    const int qq = wrap(q + tap_off(k));
    for (int m1 = 0; m1 < M1; ++m1)
      acc = __fmaf_rn(w[m2 * NT * M1 + k * M1 + m1], p1[m1 * pstride + qq],
                      acc);
  }
  return __fadd_rn(acc, b2[m2]);
}

__device__ __forceinline__ bool valid_pos(int q) {
  return q / P1 < C2 && q % P1 < C2;
}

// masked activation: leaky .05 on the valid positions, BIG_NEG elsewhere
__device__ __forceinline__ float sec_zm(float z, int q) {
  if (!valid_pos(q)) return BIG_NEG;
  return __fadd_rn(fmaxf(z, 0.0f), __fmul_rn(SLOPE, fminf(z, 0.0f)));
}

// the 2x2 window max at anchor q (two separable circular max rolls)
__device__ __forceinline__ float sec_mx(const float* zm, int q) {
  const float r0 = fmaxf(zm[q], zm[wrap(q + 1)]);
  const float r1 = fmaxf(zm[wrap(q + P1)], zm[wrap(q + P1 + 1)]);
  return fmaxf(r0, r1);
}

// the pool backward at q: the gradient 0.001 * p2 of its window reaches q
// when q holds the window's max; times the leaky slope of z
__device__ __forceinline__ float sec_dz(const float* z, const float* zm,
                                       const float* mx, int q) {
  const int y = q / P1, x = q % P1;
  const int qx = (x & 1) ? (q == 0 ? PQ - 1 : q - 1) : q;
  const int qy = (y & 1) ? (qx >= P1 ? qx - P1 : qx + PQ - P1) : qx;
  const float mxe = mx[qy];
  float dmx = 0.0f;
  if (y < C2 && x < C2)
    dmx = mx[(y & ~1) * P1 + (x & ~1)] * 0.001f;
  const float dza = zm[q] == mxe ? dmx : 0.0f;
  return dza * (z[q] > 0.0f ? 1.0f : SLOPE);
}

// s = sum(x) * 1e-6 over the step's (8, 128) block, by the calling block
__device__ float sec_scale(const float* __restrict__ x, double* red) {
  double t = 0.0;
  for (int e = threadIdx.x; e < 8 * 128; e += blockDim.x) t += x[e];
  return __fmul_rn((float)block_sum(t, red), 1e-6f);
}

__device__ __forceinline__ float sec_p1(float s, int q) {
  return __fmul_rn((float)(q % 31), s);
}

// --- a block per step, one sample's planes at a time in shared memory
struct SecShared {
  float p1[M1 * PQ], z[M2 * PQ], zm[M2 * PQ], mx[M2 * PQ], dz[M2 * PQ];
  float dw[NW];
};

__global__ void __launch_bounds__(T)
k_sec_block(const float* __restrict__ xs, const float* __restrict__ w,
            const float* __restrict__ b2, float* __restrict__ out,
            long long step0) {
  extern __shared__ float smem[];
  SecShared& S = *reinterpret_cast<SecShared*>(smem);
  __shared__ double red[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long step = step0 + blockIdx.x;
  const float s = sec_scale(xs + step * 8 * 128, red);
  for (int e = tid; e < NW; e += nt) S.dw[e] = 0.0f;
  double d0 = 0.0, dall = 0.0, p2s = 0.0;
  for (int b = 0; b < B; ++b) {
    for (int e = tid; e < M1 * PQ; e += nt) S.p1[e] = sec_p1(s, e % PQ);
    __syncthreads();
    for (int e = tid; e < M2 * PQ; e += nt) {
      const int m2 = e / PQ, q = e % PQ;
      const float z = sec_z(w, b2, S.p1, PQ, m2, q);
      S.z[e] = z;
      S.zm[e] = sec_zm(z, q);
    }
    __syncthreads();
    for (int e = tid; e < M2 * PQ; e += nt)
      S.mx[e] = sec_mx(S.zm + (e / PQ) * PQ, e % PQ);
    __syncthreads();
    for (int e = tid; e < M2 * PQ; e += nt) {
      const int o = (e / PQ) * PQ;
      S.dz[e] = sec_dz(S.z + o, S.zm + o, S.mx + o, e % PQ);
    }
    if (b == 0 && tid < P2Q)   // p2 row (m2 0, b 0): the window maxima
      p2s += S.mx[(2 * (tid / P2)) * P1 + 2 * (tid % P2)];
    __syncthreads();
    // dw[m2][k*M1 + m1] += sum_q dz(m2, q) p1(m1, q + off(k))
    for (int e = tid; e < NW; e += nt) {
      const int m2 = e / (NT * M1), k = (e / M1) % NT, m1 = e % M1;
      const int off = tap_off(k);
      float t = 0.0f;
      for (int q = 0; q < PQ; ++q)
        t = __fmaf_rn(S.dz[m2 * PQ + q], S.p1[m1 * PQ + wrap(q + off)], t);
      S.dw[e] = __fadd_rn(S.dw[e], t);
    }
    // dpp(m1, q) = sum_k sum_m2 w[m2][k*M1 + m1] dz(m2, q - off(k))
    for (int e = tid; e < M1 * PQ; e += nt) {
      const int m1 = e / PQ, q = e % PQ;
      float t = 0.0f;
      for (int k = 0; k < NT; ++k) {
        const int qq = q - tap_off(k) < 0 ? q - tap_off(k) + PQ
                                          : q - tap_off(k);
        for (int m2 = 0; m2 < M2; ++m2)
          t = __fmaf_rn(w[m2 * NT * M1 + k * M1 + m1], S.dz[m2 * PQ + qq], t);
      }
      dall += t;
      if (b == 0 && m1 == 0) d0 += t;
    }
    __syncthreads();
  }
  double sdw = 0.0;
  for (int e = tid; e < NW; e += nt) sdw += S.dw[e];
  const float fdw = (float)block_sum(sdw, red);
  const float fd0 = (float)block_sum(d0, red);
  const float fp2 = (float)block_sum(p2s, red);
  const float fall = (float)block_sum(dall, red);
  if (tid == 0) {
    out[step * 2] = __fadd_rn(__fadd_rn(fdw, fd0), fp2);
    out[step * 2 + 1] = fall;
  }
}

// --- a thread per output, planes in device memory, 7 launches a step.
// Scratch (floats): s 1, p1 M1*B*PQ, z, zm, mx, dz M2*B*PQ each, dw NW,
// dpp M1*B*PQ; plane (m, b) at (m*B + b)*PQ, as the striped rows.
struct SecScratch {
  float *s, *p1, *z, *zm, *mx, *dz, *dw, *dpp;
};

constexpr long long SEC_SCRATCH = 1 + 2LL * M1 * B * PQ + 4LL * M2 * B * PQ
                                  + NW;

SecScratch sec_carve(float* base) {
  SecScratch c;
  c.s = base;
  c.p1 = c.s + 1;
  c.z = c.p1 + M1 * B * PQ;
  c.zm = c.z + M2 * B * PQ;
  c.mx = c.zm + M2 * B * PQ;
  c.dz = c.mx + M2 * B * PQ;
  c.dw = c.dz + M2 * B * PQ;
  c.dpp = c.dw + NW;
  return c;
}

__global__ void k_sec_in(const float* __restrict__ x, SecScratch c) {
  __shared__ double red[32];
  const float s = sec_scale(x, red);
  if (threadIdx.x == 0) c.s[0] = s;
  for (int e = threadIdx.x; e < M1 * B * PQ; e += blockDim.x)
    c.p1[e] = sec_p1(s, e % PQ);
}

__global__ void k_sec_fwd(const float* __restrict__ w,
                          const float* __restrict__ b2, SecScratch c) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M2 * B * PQ) return;
  const int q = e % PQ, b = (e / PQ) % B, m2 = e / (B * PQ);
  const float z = sec_z(w, b2, c.p1 + b * PQ, B * PQ, m2, q);
  c.z[e] = z;
  c.zm[e] = sec_zm(z, q);
}

__global__ void k_sec_pool(SecScratch c) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M2 * B * PQ) return;
  c.mx[e] = sec_mx(c.zm + (e / PQ) * PQ, e % PQ);
}

__global__ void k_sec_dz(SecScratch c) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M2 * B * PQ) return;
  const int o = (e / PQ) * PQ;
  c.dz[e] = sec_dz(c.z + o, c.zm + o, c.mx + o, e % PQ);
}

__global__ void k_sec_dw(SecScratch c) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= NW) return;
  const int m2 = e / (NT * M1), k = (e / M1) % NT, m1 = e % M1;
  const int off = tap_off(k);
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float* dz = c.dz + (m2 * B + b) * PQ;
    const float* p1 = c.p1 + (m1 * B + b) * PQ;
    float t = 0.0f;
    for (int q = 0; q < PQ; ++q) t = __fmaf_rn(dz[q], p1[wrap(q + off)], t);
    acc = __fadd_rn(acc, t);
  }
  c.dw[e] = acc;
}

__global__ void k_sec_dpp(const float* __restrict__ w, SecScratch c) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M1 * B * PQ) return;
  const int q = e % PQ, b = (e / PQ) % B, m1 = e / (B * PQ);
  float t = 0.0f;
  for (int k = 0; k < NT; ++k) {
    const int qq = q - tap_off(k) < 0 ? q - tap_off(k) + PQ : q - tap_off(k);
    for (int m2 = 0; m2 < M2; ++m2)
      t = __fmaf_rn(w[m2 * NT * M1 + k * M1 + m1],
                    c.dz[(m2 * B + b) * PQ + qq], t);
  }
  c.dpp[e] = t;
}

__global__ void k_sec_out(SecScratch c, float* __restrict__ out) {
  __shared__ double red[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  double sdw = 0.0, d0 = 0.0, p2s = 0.0, dall = 0.0;
  for (int e = tid; e < NW; e += nt) sdw += c.dw[e];
  for (int e = tid; e < PQ; e += nt) d0 += c.dpp[e];
  for (int e = tid; e < P2Q; e += nt)   // row (m2 0, b 0) at the anchors
    p2s += c.mx[(2 * (e / P2)) * P1 + 2 * (e % P2)];
  for (int e = tid; e < M1 * B * PQ; e += nt) dall += c.dpp[e];
  const float fdw = (float)block_sum(sdw, red);
  const float fd0 = (float)block_sum(d0, red);
  const float fp2 = (float)block_sum(p2s, red);
  const float fall = (float)block_sum(dall, red);
  if (tid == 0) {
    out[0] = __fadd_rn(__fadd_rn(fdw, fd0), fp2);
    out[1] = fall;
  }
}

int blocks(long long n) { return (int)((n + T - 1) / T); }

// ------------------------------------------------------------------ relay

constexpr int HW = 784, HWP = 896;

// One block a step: rows [j*G, (j+1)*G) of the (B, HW) batch into slot j
// (columns [j*HWP, j*HWP + HW)) of a (G, g*HWP) shared-memory scratch, then
// the sum of each slot's values read back, slot by slot.
__global__ void k_relay(const float* __restrict__ xs, int G, int g,
                        float* __restrict__ out, long long step0) {
  extern __shared__ float xg[];
  __shared__ double red[32];
  const long long step = step0 + blockIdx.x;
  const float* x = xs + step * B * HW;
  const int W = g * HWP;
  for (int e = threadIdx.x; e < B * HW; e += blockDim.x) {
    const int r = e / HW, p = e % HW, j = r / G;
    xg[(r - j * G) * W + j * HWP + p] = x[e];
  }
  __syncthreads();
  float acc = 0.0f;
  for (int j = 0; j < g; ++j) {
    double t = 0.0;
    for (int e = threadIdx.x; e < G * HW; e += blockDim.x)
      t += xg[(e / HW) * W + j * HWP + e % HW];
    acc = __fadd_rn(acc, (float)block_sum(t, red));
  }
  if (threadIdx.x == 0) out[step] = acc;
}

}  // namespace

extern "C" {

const char* probes_error_string(int code) {
  if (code == -1) return "an input block needs more shared memory than a "
                         "block can hold";
  if (code == -2) return "the steps do not divide into blocks of U";
  if (code == -3) return "more input streams than the kernel takes";
  if (code == -4) return "unknown section variant";
  if (code == -5) return "G x g is not the batch of 20";
  return cudaGetErrorString((cudaError_t)code);
}

// The floor probe over ``n_steps`` steps of ``n_in`` input streams
// (pointers ``ptrs``, words a step ``elems``, first-row words ``cols``,
// ``isint`` for int32 words): ``out`` (n_steps, W). ``per_launch`` 0 runs
// one launch an epoch, else one launch a block of U steps; ``launched``
// receives the launches.
int floor_probe(void* const* ptrs, const long long* elems, const int* cols,
                const int* isint, int n_in, int n_steps, int U, int W,
                float* out, int per_launch, long long* launched, int device,
                void* stream_) {
  CHECK(cudaSetDevice(device));
  cudaStream_t s = (cudaStream_t)stream_;
  *launched = 0;
  if (n_in > MAX_IN) return -3;
  if (U < 1 || n_steps % U) return -2;
  FloorIn in;
  long long most = 0;
  for (int i = 0; i < n_in; ++i) {
    in.p[i] = (const float*)ptrs[i];
    in.elems[i] = elems[i];
    in.cols[i] = cols[i];
    in.isint[i] = isint[i];
    most = elems[i] > most ? elems[i] : most;
  }
  in.n = n_in;
  const size_t smem = sizeof(float) * (size_t)most;
  if (!smem_opt_in(k_floor, smem)) return -1;
  const long long iters = n_steps / U;
  if (!per_launch) {
    k_floor<<<(unsigned)iters, T, smem, s>>>(in, 0, U, W, out);
    CHECK(cudaGetLastError());
    *launched = 1;
    return 0;
  }
  for (long long it = 0; it < iters; ++it) {
    k_floor<<<1, T, smem, s>>>(in, it, U, W, out);
    CHECK(cudaGetLastError());
    ++*launched;
  }
  return 0;
}

// Floats of scratch the thread-per-output section needs.
long long conv_section_scratch_floats() { return SEC_SCRATCH; }

// The conv2 section over ``n_steps`` steps of (8, 128) blocks ``xs``, with
// weights w (M2, 9*M1) and bias b2 (M2,): ``out`` (n_steps, 2), each step's
// sum(dw) + sum(dpp[0]) + sum(p2[0]) and sum(dpp). ``variant`` 0: a block a
// step, in one launch (``per_launch`` 0) or a launch a step; 1: a thread
// per output (7 launches a step, over ``scratch``). ``launched`` receives
// the launches.
int conv_section(const float* xs, const float* w, const float* b2,
                 int n_steps, int variant, int per_launch, float* out,
                 float* scratch, long long* launched, int device,
                 void* stream_) {
  CHECK(cudaSetDevice(device));
  cudaStream_t s = (cudaStream_t)stream_;
  *launched = 0;
  if (variant == 0) {
    const size_t smem = sizeof(SecShared);
    if (!smem_opt_in(k_sec_block, smem)) return -1;
    for (int st = 0; st < n_steps; st += per_launch ? 1 : n_steps) {
      k_sec_block<<<per_launch ? 1 : n_steps, T, smem, s>>>(xs, w, b2, out,
                                                            st);
      CHECK(cudaGetLastError());
      ++*launched;
    }
    return 0;
  }
  if (variant != 1) return -4;
  const SecScratch c = sec_carve(scratch);
  const long long nz = (long long)M2 * B * PQ;
  for (int st = 0; st < n_steps; ++st) {
    k_sec_in<<<1, 1024, 0, s>>>(xs + (long long)st * 8 * 128, c);
    k_sec_fwd<<<blocks(nz), T, 0, s>>>(w, b2, c);
    k_sec_pool<<<blocks(nz), T, 0, s>>>(c);
    k_sec_dz<<<blocks(nz), T, 0, s>>>(c);
    k_sec_dw<<<blocks(NW), T, 0, s>>>(c);
    k_sec_dpp<<<blocks((long long)M1 * B * PQ), T, 0, s>>>(w, c);
    k_sec_out<<<1, T, 0, s>>>(c, out + 2LL * st);
    CHECK(cudaGetLastError());
    *launched += 7;
  }
  return 0;
}

// The relay over ``n_steps`` (20, 784) batches ``xs``: ``out`` (n_steps,),
// in one launch (``per_launch`` 0) or a launch a step.
int relay_probe(const float* xs, int n_steps, int G, int g, int per_launch,
                float* out, long long* launched, int device, void* stream_) {
  CHECK(cudaSetDevice(device));
  *launched = 0;
  if (G * g != B) return -5;
  const size_t smem = sizeof(float) * (size_t)G * g * HWP;
  if (!smem_opt_in(k_relay, smem)) return -1;
  for (int st = 0; st < n_steps; st += per_launch ? 1 : n_steps) {
    k_relay<<<per_launch ? 1 : n_steps, T, smem, (cudaStream_t)stream_>>>(
        xs, G, g, out, st);
    CHECK(cudaGetLastError());
    ++*launched;
  }
  return 0;
}

}  // extern "C"

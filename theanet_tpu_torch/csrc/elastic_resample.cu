// Resample a batch at one shared warp, with invert and pixel flip, for
// Hopper (sm_90a).
//
// Replaces theanet_tpu/ops/elastic_pallas.py::_kernel (the ElasticLayer's
// 'method': 'pallas'). Its plain PyTorch version, the specification this
// file is held to, is
// theanet_tpu_torch/ops/elastic_resample.py::elastic_resample_reference.
//
// What it computes: out[r, p] for every image-channel row r of x (B*C,
// H*W) and output pixel p: the tap value v = x[r, q] (1 - v where invert)
// at q = floor(ty+.5)*W + floor(tx+.5) (nearest), or the four taps around
// (ty[p], tx[p]) weighted (1-fy)(1-fx), (1-fy)fx, fy(1-fx), fy fx
// (bilinear); then 1 - out where the element's word, as a uniform from
// its low 24 bits, is below pflip.
//
// What bounds it on the card. At mnist_cnn's shapes (20 x 1 x 28 x 28)
// the call moves ~0.2 MB and does ~0.1 M operations: far below a
// microsecond of memory or arithmetic, so it is bound by the launch.
//
// What the design does about it: the TPU kernel's (hw, hw) one-hot tap
// matrix and its product exist because Mosaic has no gather; here one
// thread per output element gathers its taps directly (each image is a
// few KB and stays in L1/L2), so there is no matrix and any image size
// works. One launch per call. Every operation of the bilinear sum is
// rounded separately (__fmul_rn/__fadd_rn, in the plain version's order):
// the resampled pixels feed a max pool whose gradient goes to every exact
// tie, so the kernel must give the plain version's bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void k_resample(int rows, int H, int W, const float* __restrict__ x,
                           const float* __restrict__ ty,
                           const float* __restrict__ tx,
                           const int* __restrict__ words, float* __restrict__ out,
                           int nearest, int invert, float pflip) {
  const int HW = H * W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * HW) return;
  const int p = (int)(i % HW);
  const float* src = x + (i - p);
  const float y = ty[p], xx = tx[p];
  float v;
  if (nearest) {
    const int q = (int)floorf(__fadd_rn(y, 0.5f)) * W
                  + (int)floorf(__fadd_rn(xx, 0.5f));
    v = src[q];
    if (invert) v = __fsub_rn(1.0f, v);
  } else {
    const int top = (int)y, left = (int)xx;   // trunc == floor: t >= 0
    const float fy = __fsub_rn(y, (float)top), fx = __fsub_rn(xx, (float)left);
    const float gy = __fsub_rn(1.0f, fy), gx = __fsub_rn(1.0f, fx);
    const int q = top * W + left;
    float t00 = src[q], t01 = src[q + 1], t10 = src[q + W], t11 = src[q + W + 1];
    if (invert) {
      t00 = __fsub_rn(1.0f, t00);
      t01 = __fsub_rn(1.0f, t01);
      t10 = __fsub_rn(1.0f, t10);
      t11 = __fsub_rn(1.0f, t11);
    }
    v = __fmul_rn(t00, __fmul_rn(gy, gx));
    v = __fadd_rn(v, __fmul_rn(t01, __fmul_rn(gy, fx)));
    v = __fadd_rn(v, __fmul_rn(t10, __fmul_rn(fy, gx)));
    v = __fadd_rn(v, __fmul_rn(t11, __fmul_rn(fy, fx)));
  }
  if (words != nullptr) {
    const float u = (float)(words[i] & 0xFFFFFF) * (1.0f / 16777216.0f);
    if (u < pflip) v = __fsub_rn(1.0f, v);
  }
  out[i] = v;
}

}  // namespace

extern "C" {

const char* elastic_resample_error_string(int code) {
  if (code == -1) return "the batch is empty or too large for one launch";
  return cudaGetErrorString((cudaError_t)code);
}

// x, out: (rows, H*W) f32; ty, tx: (H*W) f32, clipped to [0, size-1-.001];
// words: (rows, H*W) int32, or null for no pixel flip. Launches on
// ``stream`` of ``device``; returns 0 or the CUDA error of the launch.
int elastic_resample(const float* x, const float* ty, const float* tx,
                     const int* words, float* out, int rows, int H, int W,
                     int nearest, int invert, float pflip, int device,
                     void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)rows * H * W;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (n <= 0 || blocks > 0x7fffffffLL) return -1;
  k_resample<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      rows, H, W, x, ty, tx, words, out, nearest, invert, pflip);
  return (int)cudaGetLastError();
}

}  // extern "C"

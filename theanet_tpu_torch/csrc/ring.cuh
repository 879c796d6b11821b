// The in-epoch gradient exchange of the whole-epoch data-parallel entries
// (megastep_ring_epoch in megastep.cu, deep_ring_epoch in megastep_deep.cu),
// for Hopper (sm_90a). Included by both fused libraries, as stages.cuh is.
//
// Replaces the exchange inside theanet_tpu/ops/megastep_ring.py::_kernel_ring
// (the Pallas whole-epoch ring kernel): its pass-along all-gather with a
// canonical-order sum (n = 2), its ring reduce-scatter + all-gather over
// _owner_groups (n >= 3), and its (cost, minf) stats gather. The plain
// version that this file is held to is
// theanet_tpu_torch/ops/megastep_ring.py::exchange_reference.
//
// Form. Every rank owns one buffer allocated here with cudaMalloc (not from
// PyTorch's caching allocator, whose blocks IPC-map from their base), which
// the other ranks map through CUDA IPC (one card, or cards that are peers).
// It holds two monotonic step counters, an error word, two (cost, minf)
// stats slots, two gradient slots and two "owned" slots, each pair by step
// parity: step s + 1 never writes a slot that a slower rank may still read
// for step s, because a rank reaches step s + 2 only after every rank has
// published step s + 1, which each did after finishing its step-s reads.
// Per step:
//   * the gradient stages write this rank's gradient and stats into its
//     slot of parity s (the caller's grad_stages);
//   * k_ring_publish stores the global step number into counter A with a
//     system-scope release (after the stages' stores, which the stream
//     orders before it);
//   * gather mode: k_ring_gather waits (acquire) until every rank's counter
//     A reached the step, then sums the ranks' slots in canonical order
//     g0 + g1 + ... + g(n-1), times inv = (float)(1/n);
//   * reduce-scatter mode: k_ring_rs sums this rank's owner chunks in the
//     ring's hop order ((g(c+1) + g(c+2)) + ...) + g(c) into its owned slot,
//     k_ring_publish stores counter B, and k_ring_ag copies every chunk's
//     sum from its owner's owned slot, times inv. On a card or on NVLink
//     (all to all) the ranks read their peers' slots directly instead of
//     passing partial sums hop by hop; the sums are taken in the hops'
//     order, so the result is the ring's to the bit;
//   * the stats: cost (c0 + ... + c(n-1)) * inv, minf the minimum over the
//     ranks (NaN if any is NaN, as jnp.minimum).
// No library collective runs inside the epoch.
//
// Waiting. No kernel spins while a peer is behind: each rank records an IPC
// event (one per counter and parity) after it publishes, and stores the step
// in a host counter shared by the ranks (a mapped file); before an exchange
// kernel the C loop waits on the host until every peer's host counter
// reached the step, then makes the stream wait on the peer's event
// (cudaStreamWaitEvent), so a waiting context leaves the card to the others
// (on one card the ranks' contexts time-slice it). A peer records an event
// of parity p again only after this rank's host passed its next step, which
// comes after this rank's stream wait, so the wait always sees the record of
// its own step. The exchange kernels still acquire the peers' counters
// before they read (a bounded device wait with __nanosleep backoff); after
// the events that wait passes at once, and it stays as the safety check of
// the memory ordering. A device spin in place of the events was measured
// 4.7x slower at 2 ranks on one card (PERF.md).
// Every wait is bounded: after ``timeout_ns`` a device wait sets the rank's
// error word (every later exchange kernel of the rank then returns at
// once, and the C entry returns RING_ERR_TIMEOUT after the epoch), a host
// wait returns RING_ERR_TIMEOUT at once.
//
// What bounds it: bytes. The gather moves (n + 1) gradient sets a step
// (n reads, one write), the reduce-scatter + all-gather about three (each
// rank reads n - 1 peers' shares of its chunks and every chunk once), at
// HBM3's 3.35 TB/s a few microseconds for the flagship's 1.47 MB set.
#pragma once

#include <sched.h>
#include <string.h>
#include <time.h>

#include "stages.cuh"

#define RING_MAX_RANKS 8
#define RING_MAX_CHUNKS 64
// error codes of the ring entries (each library's *_error_string names them)
#define RING_ERR_TIMEOUT -20
#define RING_ERR_TABLE -21

namespace {

// layout of a rank's buffer, in floats
constexpr long long RING_HEADER = 64;   // u64 counter A, u64 counter B, int err
constexpr long long RING_STATS = 64;    // 2 parities x (cost, minf), padded

__host__ __device__ inline unsigned long long* ring_counter(float* base,
                                                            int which) {
  return (unsigned long long*)base + which;
}
__host__ __device__ inline int* ring_err(float* base) {
  return (int*)(base + 4);
}
__host__ __device__ inline float* ring_stats(float* base, int par) {
  return base + RING_HEADER + 2 * par;
}
__host__ __device__ inline float* ring_slot(float* base, int par,
                                            long long ng) {
  return base + RING_HEADER + RING_STATS + (long long)par * ng;
}
__host__ __device__ inline float* ring_owned(float* base, int par,
                                             long long ng) {
  return base + RING_HEADER + RING_STATS + (2LL + par) * ng;
}

struct RingPeers {
  float* base[RING_MAX_RANKS];
};

struct RingChunks {
  int count;
  long long start[RING_MAX_CHUNKS];
  int len[RING_MAX_CHUNKS];
  int owner[RING_MAX_CHUNKS];
  int longest;
};

// The parsed ring table (ops/megastep_ring.py ring_table): n, rank, use_rs,
// step0, timeout_ns, n_chunks, the host counters (u64 at 64-byte strides,
// (rank * 2 + counter) * 8), RING_MAX_RANKS buffer bases (this rank's own
// pointer at ``rank``, the others mapped), 4 RING_MAX_RANKS events (rank r's
// at 4 r + 2 counter + parity), then (start, len, owner) a chunk. The
// pointers and events are needed at n > 1 only. ``launched`` counts the
// exchange kernels that ring_phase launched (the entries write it out).
constexpr int RING_FIXED = 7;
struct Ring {
  int n, rank, rs;
  unsigned long long step0, timeout_ns;
  unsigned long long* host;
  RingPeers peers;
  cudaEvent_t ev[RING_MAX_RANKS][4];
  RingChunks chunks;
  float* own;
  long long launched;
};

int ring_parse(const long long* t, Ring* r) {
  r->n = (int)t[0];
  r->rank = (int)t[1];
  r->rs = (int)t[2];
  r->step0 = (unsigned long long)t[3];
  r->timeout_ns = (unsigned long long)t[4];
  const int nc = (int)t[5];
  r->host = (unsigned long long*)t[6];
  r->launched = 0;
  if (r->n < 1 || r->n > RING_MAX_RANKS || r->rank < 0 || r->rank >= r->n ||
      nc < 0 || nc > RING_MAX_CHUNKS || (r->rs && r->n > 1 && nc == 0) ||
      (r->n > 1 && !r->host))
    return RING_ERR_TABLE;
  for (int k = 0; k < RING_MAX_RANKS; ++k)
    r->peers.base[k] = (float*)t[RING_FIXED + k];
  for (int k = 0; k < r->n; ++k)
    if (!r->peers.base[k] && r->n > 1) return RING_ERR_TABLE;
  const long long* e = t + RING_FIXED + RING_MAX_RANKS;
  for (int k = 0; k < RING_MAX_RANKS; ++k)
    for (int j = 0; j < 4; ++j) {
      r->ev[k][j] = (cudaEvent_t)e[4 * k + j];
      if (r->n > 1 && k < r->n && !r->ev[k][j])
        return RING_ERR_TABLE;
    }
  r->own = r->peers.base[r->rank];
  const long long* c = e + 4 * RING_MAX_RANKS;
  r->chunks.count = nc;
  r->chunks.longest = 0;
  for (int k = 0; k < nc; ++k) {
    r->chunks.start[k] = c[3 * k];
    r->chunks.len[k] = (int)c[3 * k + 1];
    r->chunks.owner[k] = (int)c[3 * k + 2];
    if (r->chunks.owner[k] < 0 || r->chunks.owner[k] >= r->n)
      return RING_ERR_TABLE;
    if (r->chunks.len[k] > r->chunks.longest)
      r->chunks.longest = r->chunks.len[k];
  }
  return 0;
}

__device__ __forceinline__ void store_release_sys(unsigned long long* p,
                                                  unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One thread: counter ``which`` of this rank's buffer := ``step``, after
// every store the stream ordered before this kernel.
__global__ void k_ring_publish(float* own, int which,
                               unsigned long long step) {
  store_release_sys(ring_counter(own, which), step);
}

// Thread 0 of a block: true once counter ``which`` of every rank has reached
// ``step``; false (and the rank's error word set) after ``timeout_ns``, or at
// once when an earlier wait of the rank failed.
__device__ bool ring_wait(const RingPeers& P, int n, int which,
                          unsigned long long step,
                          unsigned long long timeout_ns, int* err) {
  if (*(volatile int*)err) return false;
  const unsigned long long t0 = global_ns();
  unsigned ns = 64;
  for (int r = 0; r < n; ++r) {
    const unsigned long long* c = ring_counter(P.base[r], which);
    while (load_acquire_sys(c) < step) {
      if (*(volatile int*)err) return false;
      if (global_ns() - t0 > timeout_ns) {
        atomicExch(err, 1);
        return false;
      }
      __nanosleep(ns);
      if (ns < 16384) ns *= 2;
    }
  }
  return true;
}

// Block-wide: every thread returns true once the ranks have published.
__device__ bool block_wait(const RingPeers& P, int n, int which,
                           unsigned long long step,
                           unsigned long long timeout_ns, int* err) {
  __shared__ int ok;
  if (threadIdx.x == 0) ok = ring_wait(P, n, which, step, timeout_ns, err);
  __syncthreads();
  return ok != 0;
}

// (cost, minf) of the step: the canonical-order cost sum times inv, and the
// minimum over the ranks (NaN-propagating, as jnp.minimum).
__device__ void ring_stats_reduce(const RingPeers& P, int n, int par,
                                  float inv, float* cm) {
  float c = __ldcg(ring_stats(P.base[0], par));
  float m = __ldcg(ring_stats(P.base[0], par) + 1);
  for (int r = 1; r < n; ++r) {
    c = __fadd_rn(c, __ldcg(ring_stats(P.base[r], par)));
    const float v = __ldcg(ring_stats(P.base[r], par) + 1);
    m = (isnan(m) || isnan(v)) ? NAN : fminf(m, v);
  }
  cm[0] = __fmul_rn(c, inv);
  cm[1] = m;
}

// Gather mode: out = (g0 + g1 + ... + g(n-1)) * inv over every element.
__global__ void k_ring_gather(RingPeers P, int n, int par, long long ng,
                              unsigned long long step,
                              unsigned long long timeout_ns, float inv,
                              int* err, float* __restrict__ out,
                              float* __restrict__ cm) {
  if (!block_wait(P, n, 0, step, timeout_ns, err)) return;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < ng; i += stride) {
    float s = __ldcg(ring_slot(P.base[0], par, ng) + i);
    for (int r = 1; r < n; ++r)
      s = __fadd_rn(s, __ldcg(ring_slot(P.base[r], par, ng) + i));
    out[i] = __fmul_rn(s, inv);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) ring_stats_reduce(P, n, par, inv,
                                                             cm);
}

// Reduce-scatter: the chunks owned by ``me`` (blockIdx.y a chunk), summed in
// the hop order of owner c, ((g(c+1) + g(c+2)) + g(c+3)) + ... + g(c), into
// this rank's owned slot.
__global__ void k_ring_rs(RingPeers P, RingChunks C, int n, int me, int par,
                          long long ng, unsigned long long step,
                          unsigned long long timeout_ns, int* err) {
  const int k = blockIdx.y;
  if (C.owner[k] != me) return;
  if (!block_wait(P, n, 0, step, timeout_ns, err)) return;
  const long long s0 = C.start[k];
  float* dst = ring_owned(P.base[me], par, ng);
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < C.len[k];
       j += gridDim.x * blockDim.x) {
    const long long i = s0 + j;
    float s = __fadd_rn(__ldcg(ring_slot(P.base[(me + 1) % n], par, ng) + i),
                        __ldcg(ring_slot(P.base[(me + 2) % n], par, ng) + i));
    for (int h = 3; h <= n; ++h)
      s = __fadd_rn(s, __ldcg(ring_slot(P.base[(me + h) % n], par, ng) + i));
    dst[i] = s;
  }
}

// All-gather: every chunk's sum from its owner's owned slot, times inv.
__global__ void k_ring_ag(RingPeers P, RingChunks C, int n, int par,
                          long long ng, unsigned long long step,
                          unsigned long long timeout_ns, float inv, int* err,
                          float* __restrict__ out, float* __restrict__ cm) {
  if (!block_wait(P, n, 1, step, timeout_ns, err)) return;
  const int k = blockIdx.y;
  const float* src = ring_owned(P.base[C.owner[k]], par, ng);
  const long long s0 = C.start[k];
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < C.len[k];
       j += gridDim.x * blockDim.x)
    out[s0 + j] = __fmul_rn(__ldcg(src + s0 + j), inv);
  if (k == 0 && blockIdx.x == 0 && threadIdx.x == 0)
    ring_stats_reduce(P, n, par, inv, cm);
}

// After this rank published counter ``which`` of ``step``: record its event
// and store the step in its host counter.
int host_publish(const Ring& R, int which, unsigned long long step,
                 cudaStream_t s) {
  CHECK(cudaEventRecord(R.ev[R.rank][2 * which + (int)(step & 1)], s));
  __atomic_store_n(&R.host[(R.rank * 2 + which) * 8], step, __ATOMIC_RELEASE);
  return 0;
}

// Before a kernel that reads the peers' counter ``which`` of ``step``: wait on the host for each peer's host counter, then make the
// stream wait on the peer's event; RING_ERR_TIMEOUT after ``timeout_ns``.
int host_wait(const Ring& R, int which, unsigned long long step,
              cudaStream_t s) {
  timespec t0, t;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  for (int r = 0; r < R.n; ++r) {
    if (r == R.rank) continue;
    while (__atomic_load_n(&R.host[(r * 2 + which) * 8], __ATOMIC_ACQUIRE) <
           step) {
      clock_gettime(CLOCK_MONOTONIC, &t);
      if ((unsigned long long)((t.tv_sec - t0.tv_sec) * 1000000000LL +
                               (t.tv_nsec - t0.tv_nsec)) > R.timeout_ns)
        return RING_ERR_TIMEOUT;
      sched_yield();
    }
    CHECK(cudaStreamWaitEvent(s, R.ev[r][2 * which + (int)(step & 1)], 0));
  }
  return 0;
}

// The phases of one step's exchange after the gradient stages: 1 publishes
// counter A; 2 (reduce-scatter mode) sums this rank's chunks and publishes
// counter B; 3 gathers the reduced gradient into ``out`` and (cost, minf)
// into ``cm``. The epoch runs all three in order; the in-process emulation
// of n ranks runs phase 1 of every rank, then phase 2, then phase 3. Each
// kernel launched adds one to ``R.launched``.
int ring_phase(Ring& R, long long ng, unsigned long long step, int phase,
               float* out, float* cm, cudaStream_t s) {
  const int par = (int)(step & 1);
  const float inv = (float)(1.0 / R.n);
  int* err = ring_err(R.own);
  const int T = 256;
  const int xb = blocks(R.chunks.longest, T) < 128 ? blocks(R.chunks.longest, T)
                                                   : 128;
  const int gb = blocks(ng, T) < 264 ? blocks(ng, T) : 264;
  int rc = 0;
  if (phase == 1) {
    k_ring_publish<<<1, 1, 0, s>>>(R.own, 0, step);
    LAUNCHED();
    ++R.launched;
    rc = host_publish(R, 0, step, s);
  } else if (phase == 2 && R.rs) {
    if ((rc = host_wait(R, 0, step, s)) != 0) return rc;
    dim3 grid(xb, R.chunks.count);
    k_ring_rs<<<grid, T, 0, s>>>(R.peers, R.chunks, R.n, R.rank, par, ng,
                                 step, R.timeout_ns, err);
    LAUNCHED();
    k_ring_publish<<<1, 1, 0, s>>>(R.own, 1, step);
    LAUNCHED();
    R.launched += 2;
    rc = host_publish(R, 1, step, s);
  } else if (phase == 3 && R.rs) {
    if ((rc = host_wait(R, 1, step, s)) != 0) return rc;
    dim3 grid(xb, R.chunks.count);
    k_ring_ag<<<grid, T, 0, s>>>(R.peers, R.chunks, R.n, par, ng, step,
                                 R.timeout_ns, inv, err, out, cm);
    LAUNCHED();
    ++R.launched;
  } else if (phase == 3) {
    if ((rc = host_wait(R, 0, step, s)) != 0) return rc;
    k_ring_gather<<<gb, T, 0, s>>>(
        R.peers, R.n, par, ng, step, R.timeout_ns, inv, err, out, cm);
    LAUNCHED();
    ++R.launched;
  }
  return rc;
}

// One step's whole exchange (phases 1-3).
int ring_exchange_step(Ring& R, long long ng, unsigned long long step,
                       float* out, float* cm, cudaStream_t s) {
  for (int phase = 1; phase <= 3; ++phase) {
    int rc = ring_phase(R, ng, step, phase, out, cm, s);
    if (rc != 0) return rc;
  }
  return 0;
}

// After an epoch: wait for the stream, then RING_ERR_TIMEOUT if a wait of
// this rank timed out.
int ring_finish(const Ring& R, cudaStream_t s) {
  CHECK(cudaStreamSynchronize(s));
  int err = 0;
  CHECK(cudaMemcpy(&err, ring_err(R.own), sizeof(int),
                   cudaMemcpyDeviceToHost));
  return err ? RING_ERR_TIMEOUT : 0;
}

const char* ring_error_string(int code) {
  if (code == RING_ERR_TIMEOUT)
    return "ring exchange: a peer rank did not publish its step within the "
           "wait limit (a rank died or stalled)";
  if (code == RING_ERR_TABLE) return "ring exchange: malformed ring table";
  return nullptr;
}

}  // namespace

extern "C" {

// Bytes of one rank's exchange buffer for ``n_grads`` gradient floats.
long long ring_buffer_bytes(long long n_grads) {
  return (long long)sizeof(float) * (RING_HEADER + RING_STATS + 4 * n_grads);
}

// Allocate and zero this rank's buffer on ``device``; ``handle`` receives
// its CUDA IPC handle (64 bytes).
int ring_alloc(long long bytes, int device, void** ptr, void* handle) {
  CHECK(cudaSetDevice(device));
  CHECK(cudaMalloc(ptr, (size_t)bytes));
  CHECK(cudaMemset(*ptr, 0, (size_t)bytes));
  CHECK(cudaIpcGetMemHandle((cudaIpcMemHandle_t*)handle, *ptr));
  return (int)cudaDeviceSynchronize();
}

// Map another rank's buffer from its IPC handle.
int ring_open(const void* handle, int device, void** ptr) {
  CHECK(cudaSetDevice(device));
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int ring_close(void* ptr, int device) {
  CHECK(cudaSetDevice(device));
  return (int)cudaIpcCloseMemHandle(ptr);
}

int ring_free(void* ptr, int device) {
  CHECK(cudaSetDevice(device));
  return (int)cudaFree(ptr);
}

// This rank's 4 interprocess events (counter x parity) and
// their IPC handles (4 x 64 bytes).
int ring_events_alloc(int device, void** ev, void* handles) {
  CHECK(cudaSetDevice(device));
  for (int k = 0; k < 4; ++k) {
    cudaEvent_t e;
    CHECK(cudaEventCreateWithFlags(
        &e, cudaEventDisableTiming | cudaEventInterprocess));
    ev[k] = (void*)e;
    CHECK(cudaIpcGetEventHandle((cudaIpcEventHandle_t*)handles + k, e));
  }
  return 0;
}

// Another rank's 4 events from their handles.
int ring_events_open(const void* handles, int device, void** ev) {
  CHECK(cudaSetDevice(device));
  for (int k = 0; k < 4; ++k) {
    cudaIpcEventHandle_t h;
    memcpy(&h, (const cudaIpcEventHandle_t*)handles + k, sizeof(h));
    cudaEvent_t e;
    CHECK(cudaIpcOpenEventHandle(&e, h));
    ev[k] = (void*)e;
  }
  return 0;
}

int ring_events_free(void** ev, int device) {
  CHECK(cudaSetDevice(device));
  for (int k = 0; k < 4; ++k) CHECK(cudaEventDestroy((cudaEvent_t)ev[k]));
  return 0;
}

// One phase (1-3, ring_phase) of the exchange of global step ``step`` for
// the rank of ``table``, outside an epoch: the in-process emulation of n
// ranks over n buffers of one process, and the exchange's own timing.
// ``launched`` receives the number of exchange kernels launched.
int ring_exchange(const long long* table, long long n_grads, long long step,
                  int phase, float* out, float* cm, long long* launched,
                  int device, void* stream_) {
  CHECK(cudaSetDevice(device));
  Ring R;
  int rc = ring_parse(table, &R);
  if (rc != 0) return rc;
  rc = ring_phase(R, n_grads, (unsigned long long)step, phase, out, cm,
                  (cudaStream_t)stream_);
  *launched = R.launched;
  return rc;
}

}  // extern "C"

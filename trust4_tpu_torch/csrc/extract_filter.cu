// CUDA kernel for extraction's exact candidate filter: the low-complexity
// guard and HasHitInSet of every read of a bulk stream batch
// (native/extract_filter.cpp t4x_extract_stream, through its batch
// decider).  It replaces no TPU kernel: the JAX package decides these
// reads in host C++ (its native/extract_filter.cpp), and its device
// prefilter (ops/prefilter.py) is a conservative superset that rules out
// nothing at k = 9 and a hit length of 23 (that module's docstring).
//
// What bounds it on an H100: gathers, not arithmetic.  A random 100-base
// read looks up 184 windows of both strands in a 4^9 + 1 table of
// posting starts (1 MB) and reads about 150 postings (8 bytes each) from
// a 1.8 MB table: small dependent loads, all of them hits in the 50 MB L2
// once the tables have been read, beside 100 bytes of the read itself
// from the host.  One thread a read would leave each scheduler one or two
// warps, each waiting out every load in turn.
//
// Design: one warp a read.  The lanes look up the read's windows 32 at a
// time (lane l window l of the round), so a warp has 32 table loads in
// flight where a thread would have one; then they share the round's
// postings out evenly through a prefix of the windows' posting counts in
// shared memory, since one k-mer may carry a hundred postings and most
// carry none or one (at lane per window the warp would wait out the
// longest list: 24 posting loads a strand of a random read against 3).
// Each counts the sequences of its postings into the warp's counts in
// shared memory (an atomic add a sequence a window, and an atomic max of
// the count packed with the sequence index for the strand's best), and
// after a warp barrier the lanes gather the best sequence's hits the same
// way into the warp's bucket in shared memory.  The chain (sort, runs,
// LIS) runs on the lead lane over that bucket: for a random read it holds
// a few hits.  The per-read
// logic is extract_filter.cuh's, which the CPU tests build with g++ and
// hold against the host filter; this file adds the lanes' atomics and
// shuffles, the warps' slices of shared memory and the C entries.
//
// Plain C interface for ctypes (ops/build.py, ops/extract_filter.py):
// t4_extract_filter launches on a stream and returns the cudaError_t of
// the launch; t4_extract_decide is the stream's batch decider (copy in,
// launch, copy out, a bounded wait), called from native code with a
// context the wrapper fills.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <chrono>
#include <thread>

#include "extract_filter.cuh"

namespace {

constexpr int kMaxWarps = 4;  // a block's warps, one read each
constexpr size_t kSmemMax = 227 * 1024;

// The card's warp: each thread is one lane; the warp's shared words take
// atomics, and the sums and the lead's result cross the warp by shuffles.
struct WarpLanes {
  static constexpr int N = 1;
  int my_lane;

  __host__ __device__ int lane(int) const { return my_lane; }
  __host__ __device__ bool lead() const { return my_lane == 0; }
  __host__ __device__ uint32_t add(uint32_t* p) const {
#ifdef __CUDA_ARCH__
    return atomicAdd(p, 1u);
#else
    return (*p)++;
#endif
  }
  __host__ __device__ void max(uint32_t* p, uint32_t v) const {
#ifdef __CUDA_ARCH__
    atomicMax(p, v);
#else
    if (v > *p) *p = v;
#endif
  }
  __host__ __device__ int sum(int v) const {
#ifdef __CUDA_ARCH__
    return __reduce_add_sync(0xffffffffu, v);
#else
    return v;
#endif
  }
  __host__ __device__ int bcast(int v) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xffffffffu, v, 0);
#else
    return v;
#endif
  }
  __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
  // pre[l] = n[0] + ... + n[l - 1] (HostLanes::prefix): a shuffle scan.
  __host__ __device__ void prefix(const int32_t* n, int32_t* pre) const {
#ifdef __CUDA_ARCH__
    const int own = n[my_lane];
    int v = own;
    for (int d = 1; d < 32; d *= 2) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (my_lane >= d) v += u;
    }
    pre[my_lane] = v - own;
    if (my_lane == 31) pre[32] = v;
#endif
  }
};

// 32-bit words of a warp's slice: the best and the hit count, a round's
// windows (first postings, numbers, prefix), the bucket, the lead lane's
// scratch, then the counts.
constexpr size_t kRoundWords = 3 * t4xf::kLanes + 1;
constexpr size_t kBucketAt = 2 + kRoundWords;
constexpr size_t kScratchAt =
    kBucketAt + sizeof(t4xf::Hit) * t4xf::kBucketCap / 4;
constexpr size_t kFixedWords = kScratchAt + sizeof(t4xf::Scratch) / 4;

size_t warp_words(int n_seqs) { return kFixedWords + (size_t)n_seqs; }

int warps_for(int n_seqs) {
  const size_t bytes = 4 * warp_words(n_seqs);
  const int w = (int)(kSmemMax / bytes);
  return w < kMaxWarps ? w : kMaxWarps;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    extract_filter_kernel(t4xf::Tables T, const uint8_t* __restrict__ bases,
                          const int32_t* __restrict__ offs, int n,
                          int8_t* __restrict__ out, int words) {
  extern __shared__ uint32_t smem[];
  const int wib = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  uint32_t* mine = smem + (size_t)wib * words;
  t4xf::Shared sh;
  sh.best = mine;
  sh.n_hits = mine + 1;
  sh.wb = reinterpret_cast<int32_t*>(mine + 2);
  sh.wn = sh.wb + t4xf::kLanes;
  sh.pre = sh.wn + t4xf::kLanes;
  sh.bucket = reinterpret_cast<t4xf::Hit*>(mine + kBucketAt);
  sh.scratch = reinterpret_cast<t4xf::Scratch*>(mine + kScratchAt);
  sh.cnt = mine + kFixedWords;
  for (int i = lane; i < T.n_seqs; i += 32) sh.cnt[i] = 0;
  __syncwarp();
  const int r = blockIdx.x * (blockDim.x / 32) + wib;
  if (r >= n) return;  // the whole warp: r is the warp's
  const int b = offs[r];
  const int v = t4xf::decide_read(WarpLanes{lane}, T, bases + b,
                                  offs[r + 1] - b, sh);
  if (lane == 0) out[r] = (int8_t)v;
}

std::atomic<long long> g_launches{0};

// The wrapper's context of the stream's decider (ops/extract_filter.py
// _Ctx, field for field): the device tables, the pinned host staging the
// stream packs, the device staging, the stream, and what went wrong.
struct CardCtx {
  const void* off;
  const void* posts;
  int32_t k, radius, hlr, n_seqs;
  const void* h_bases;
  const void* h_offs;
  void* h_out;
  void* d_bases;
  void* d_offs;
  void* d_out;
  void* stream;
  int32_t device;
  int32_t error;  // the failing call's cudaError_t, or kTimedOut
  double timeout_s;
};

constexpr int32_t kTimedOut = -1;

}  // namespace

extern "C" {

// The most sequences an index may hold for the kernel: a warp's counts
// and scratch must fit a block's shared memory.
int t4_extract_filter_max_seqs() {
  return (int)(kSmemMax / 4 - kFixedWords);
}

long long t4_extract_filter_launches() { return g_launches.load(); }

// out[i] for the n reads bases[offs[i]..offs[i+1]): 0, -1 / 1 or 2
// (undecided: extract_filter.cuh's caps).  Device pointers; off and posts
// are the index's tables (Tables).
int t4_extract_filter(const void* off, const void* posts, int k, int radius,
                      int hlr, int n_seqs, const void* bases,
                      const void* offs, int n, void* out, void* stream) {
  if (n <= 0) return 0;
  const int warps = warps_for(n_seqs);
  if (warps < 1 || n_seqs < 0 || n_seqs > (int)t4xf::kSeqMask)
    return (int)cudaErrorInvalidValue;
  const size_t words = warp_words(n_seqs);
  const size_t smem = 4 * words * (size_t)warps;
  cudaError_t e = cudaFuncSetAttribute(
      extract_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  t4xf::Tables T{static_cast<const int32_t*>(off),
                 static_cast<const int32_t*>(posts), k, radius, hlr, n_seqs};
  const int grid = (n + warps - 1) / warps;
  extract_filter_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      T, static_cast<const uint8_t*>(bases),
      static_cast<const int32_t*>(offs), n, static_cast<int8_t*>(out),
      (int)words);
  e = cudaGetLastError();
  if (e == cudaSuccess) g_launches++;
  return (int)e;
}

// The bulk stream's batch decider (t4x_decider in
// native/extract_filter.cpp): the n reads and their n + 1 offsets packed
// in the context's pinned staging go to the card, the kernel decides
// them, and their decisions come back into h_out; the wait for them is
// polled, bounded by timeout_s.  Returns 0, or 1 with ctx->error set.
int t4_extract_decide(void* ctx, int n, int64_t n_bases) {
  CardCtx* c = static_cast<CardCtx*>(ctx);
  cudaStream_t s = (cudaStream_t)c->stream;
  cudaError_t e = cudaSetDevice(c->device);
  if (e == cudaSuccess)
    e = cudaMemcpyAsync(c->d_bases, c->h_bases, (size_t)n_bases,
                        cudaMemcpyHostToDevice, s);
  if (e == cudaSuccess)
    e = cudaMemcpyAsync(c->d_offs, c->h_offs, sizeof(int32_t) * (n + 1),
                        cudaMemcpyHostToDevice, s);
  if (e == cudaSuccess)
    e = (cudaError_t)t4_extract_filter(c->off, c->posts, c->k, c->radius,
                                       c->hlr, c->n_seqs, c->d_bases,
                                       c->d_offs, n, c->d_out, c->stream);
  if (e == cudaSuccess)
    e = cudaMemcpyAsync(c->h_out, c->d_out, (size_t)n,
                        cudaMemcpyDeviceToHost, s);
  if (e == cudaSuccess) {
    const auto t0 = std::chrono::steady_clock::now();
    double pause = 1e-5;
    for (;;) {
      e = cudaStreamQuery(s);
      if (e != cudaErrorNotReady) break;
      const std::chrono::duration<double> waited =
          std::chrono::steady_clock::now() - t0;
      if (waited.count() >= c->timeout_s) {
        c->error = kTimedOut;
        return 1;
      }
      std::this_thread::sleep_for(std::chrono::duration<double>(pause));
      pause = pause * 2 < 1e-4 ? pause * 2 : 1e-4;
    }
  }
  c->error = (int32_t)e;
  return e == cudaSuccess ? 0 : 1;
}

}  // extern "C"

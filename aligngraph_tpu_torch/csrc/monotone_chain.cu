// The contig aligner's chain DP over M-blocks, many placements at once,
// written by hand for Hopper (sm_90a).  Plain C entry point, loaded with
// ctypes by aligngraph_tpu_torch/ops/_build.py and wrapped by
// ops/monotone_chain.py (monotone_chain_cuda; the plain version is
// monotone_chain_plain there).
//
// Replaces host code, not a Pallas kernel: the JAX package runs this loop
// on the host, in ContigAligner._enforce_monotone
// (aligngraph_tpu/align/contig_aligner.py:185-196), and the port ran it
// in C++ (native/chain.cpp) once per placement.
//
// Semantics (native/chain.cpp's, bit for bit).  A placement's m blocks
// have target spans [t0, t1) and weights w, in query order.  best[i]
// starts at w[i]; for i = 1..m-1 the gain of j < i is best[j] + (w[i] -
// ov), ov = max(t1[j] - t0[i], 0), when that kept weight is > 0, else -1;
// j is the FIRST j of largest gain, taken when its gain is > best[i]
// (then parent[i] = j, trim[i] = ov).  keep marks the blocks on the parent
// walk from the first argmax of best.
//
// Layouts (int64 unless named, contiguous, the placements back to back):
//   t0, t1, w, best, parent, trim  [n_blocks]
//   keep                           [n_blocks] uint8
//   offsets                        [n_placements + 1], placement p's
//                                  blocks are offsets[p]..offsets[p+1]-1
//
// What bounds it on this card: operations, and the DP's order.  A
// placement of m blocks does m(m-1)/2 (i, j) pairs of about nine int64
// operations each, and step i needs every best[j < i], so its m steps run
// in order.  Its inputs and outputs are 49 bytes a block, far below the
// operations for any m past a few.
//
// Design: one CTA a placement, so the placements run side by side on the
// SMs: 256 threads when every placement of the launch has at most
// kWideFrom blocks, else 1,024 (a step's loads and its chain of int64
// operations are latency-bound; more warps hide more of it).  Within
// one, step i is a block-wide argmax: the threads stride over j < i
// keeping their own first max, then warp shuffles and a shared-memory
// pass reduce (gain, j) with the first-index rule, and thread 0 writes
// best[i], parent[i] and trim[i]; the CTA synchronises before step i+1.
// best and t1, which every step reads whole, stay in shared memory (16
// bytes a block) when the placement has at most kSmemBlocks blocks, and
// are read from global memory (best is then the output array itself)
// otherwise.  Then one thread walks the parents from the first argmax of
// best.  Nothing is allocated; the launch is on the caller's stream and
// does not synchronise.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// the largest placement that still runs on 256 threads a CTA
constexpr int kWideFrom = 1024;
// blocks a CTA keeps in shared memory: 8,192 x 16 bytes = 128 KB of the
// 227 KB a block may opt in to
constexpr int kSmemBlocks = 8192;

__device__ __forceinline__ bool better(long long g, long long j,
                                       long long g2, long long j2) {
  return g > g2 || (g == g2 && j < j2);
}

__device__ __forceinline__ void warp_argmax(long long& g, long long& j) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long g2 = __shfl_down_sync(kFull, g, o);
    const long long j2 = __shfl_down_sync(kFull, j, o);
    if (better(g2, j2, g, j)) {
      g = g2;
      j = j2;
    }
  }
}

// The largest (g, j) of the CTA by `better`, in thread 0.  Every thread
// calls it; it synchronises once, and the caller synchronises before the
// next call (red_g / red_j are reused).
template <int kWarps>
__device__ __forceinline__ void block_argmax(long long& g, long long& j,
                                             long long* red_g,
                                             long long* red_j) {
  warp_argmax(g, j);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_g[warp] = g;
    red_j[warp] = j;
  }
  __syncthreads();
  if (warp == 0) {
    g = lane < kWarps ? red_g[lane] : LLONG_MIN;
    j = lane < kWarps ? red_j[lane] : LLONG_MAX;
    warp_argmax(g, j);
  }
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    monotone_chain_kernel(const long long* __restrict__ t0,
                          const long long* __restrict__ t1,
                          const long long* __restrict__ w,
                          const long long* __restrict__ offsets,
                          long long* __restrict__ best,
                          long long* __restrict__ parent,
                          long long* __restrict__ trim,
                          unsigned char* __restrict__ keep,
                          int smem_blocks) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ long long smem[];  // best [smem_blocks], t1 [...]
  __shared__ long long red_g[kWarps];
  __shared__ long long red_j[kWarps];
  const long long base = offsets[blockIdx.x];
  const long long m = offsets[blockIdx.x + 1] - base;
  t0 += base;
  t1 += base;
  w += base;
  best += base;
  parent += base;
  trim += base;
  keep += base;
  const bool in_smem = m <= smem_blocks;
  long long* b = in_smem ? smem : best;
  const long long* e = in_smem ? smem + smem_blocks : t1;
  for (long long k = threadIdx.x; k < m; k += kThreads) {
    b[k] = w[k];
    parent[k] = -1;
    trim[k] = 0;
    keep[k] = 0;
    if (in_smem) smem[smem_blocks + k] = t1[k];
  }
  __syncthreads();
  for (long long i = 1; i < m; ++i) {
    const long long ti = t0[i];
    const long long wi = w[i];
    long long g = LLONG_MIN;
    long long j = LLONG_MAX;
    // each thread's j ascend, so a strict > keeps its first max
#pragma unroll 4
    for (long long k = threadIdx.x; k < i; k += kThreads) {
      const long long ov = max(e[k] - ti, 0LL);
      const long long kept = wi - ov;
      const long long gk = kept > 0 ? b[k] + kept : -1;
      if (gk > g) {
        g = gk;
        j = k;
      }
    }
    block_argmax<kWarps>(g, j, red_g, red_j);
    if (threadIdx.x == 0 && g > b[i]) {
      b[i] = g;
      parent[i] = j;
      trim[i] = max(e[j] - ti, 0LL);
    }
    __syncthreads();
  }
  // the first argmax of best, then the walk up its parents
  long long g = LLONG_MIN;
  long long j = LLONG_MAX;
  for (long long k = threadIdx.x; k < m; k += kThreads) {
    if (b[k] > g) {
      g = b[k];
      j = k;
    }
  }
  block_argmax<kWarps>(g, j, red_g, red_j);
  if (threadIdx.x == 0 && m > 0) {
    for (long long k = j; k >= 0; k = parent[k]) keep[k] = 1;
  }
  if (in_smem) {
    for (long long k = threadIdx.x; k < m; k += kThreads) best[k] = b[k];
  }
}

// Makes `device` current for the life of the guard and then restores the
// caller's device (as csrc/banded_sw.cu's).
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = (int)cudaGetDevice(&prev_);
    if (err_ == 0 && prev_ != device) {
      err_ = (int)cudaSetDevice(device);
      restore_ = err_ == 0;
    }
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(prev_);
  }
  int error() const { return err_; }

 private:
  int prev_ = 0;
  int err_ = 0;
  bool restore_ = false;
};

}  // namespace

extern "C" {

// n_placements CTAs; max_m is the largest placement's block count (it
// sizes the shared memory).  Returns the first CUDA error of selecting the
// device, of setting the kernel's shared memory or of the launch.
int ag_monotone_chain(const long long* t0, const long long* t1,
                      const long long* w, const long long* offsets,
                      long long* best, long long* parent, long long* trim,
                      unsigned char* keep, int n_placements, int max_m,
                      int device, void* stream) {
  if (n_placements <= 0) return 0;
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const int smem_blocks = max_m < kSmemBlocks ? max_m : kSmemBlocks;
  const int bytes = 2 * smem_blocks * (int)sizeof(long long);
  const auto launch = [&](auto kernel, int threads) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return err;
    kernel<<<n_placements, threads, bytes, (cudaStream_t)stream>>>(
        t0, t1, w, offsets, best, parent, trim, keep, smem_blocks);
    return (int)cudaGetLastError();
  };
  return max_m <= kWideFrom ? launch(monotone_chain_kernel<256>, 256)
                            : launch(monotone_chain_kernel<1024>, 1024);
}

}  // extern "C"

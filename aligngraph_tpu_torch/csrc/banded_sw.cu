// Banded affine-gap local DP (Smith-Waterman) and its traceback, written by
// hand for Hopper (sm_90a).  Plain C entry points, loaded with ctypes by
// aligngraph_tpu_torch/ops/_build.py and wrapped by ops/banded_sw_cuda.py.
//
// Semantics are those of aligngraph_tpu_torch/ops/banded_sw.py (the plain
// versions, themselves bit-equal to the JAX package): band index
// b = delta + pad in [0, W = 2*pad); the diagonal dependency stays at b,
// "up" (read gap, E) is b+1, "left" (genome gap, F) is b-1; match +2,
// mismatch -3, N -1, a gap of length n costs 2 + n; the in-row F is the
// exact log-step max-decay scan over Hno.
//
// Layouts (all row-major, contiguous):
//   reads   [B, L]      int8   codes 0-3, 4 = N or padding
//   rlens   [B]         int32
//   windows [B, L + W]  int8   windows[c, x] = genome[g0 - pad + x]
//   tb      [B, L, W]   uint8  one traceback byte per (row, band) cell
//   pos_map [B, L]      int32
//
// Every entry point makes `device` current for the launch and restores the
// caller's device after it, launches on the caller's stream (a stream of
// that device), allocates nothing, does not synchronise, and returns the
// first error of selecting the device or of its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -10000000;
constexpr int kMatch = 2;
constexpr int kMismatch = -3;
constexpr int kNPen = -1;
constexpr int kGapOpen = 2;
constexpr int kGapExt = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

// sw_score_kernel (kTrace = false) and sw_dp_kernel (kTrace = true).
//
// Replaces aligngraph_tpu/ops/banded_sw_pallas.py:_kernel_score (score
// only) and :_kernel (with traceback bytes and the best cell).
//
// Design: one warp per candidate; lane b < W holds band cell b of the
// current row in registers (H, E), so the whole DP state of a candidate
// lives in one warp's registers across the L rows.  "Up" is one
// __shfl_down_sync, "left" one __shfl_up_sync, the in-row F scan log2(W)
// __shfl_up_sync steps; the row best is a warp max (__reduce_max_sync) and
// the lowest band among its ties a __ballot_sync + __ffs.  Lanes b >= W
// (W < 32) hold kNeg: shfl_up only moves values to higher lanes, so they
// never feed a live lane there, and the one shfl_down source past W-1 is
// masked to kNeg explicitly.
//
// What bounds it on this card: integer ALU and shuffle issue (about a dozen
// shuffles and ~60 integer ops per row per warp); the inputs are L + (L+W)
// bytes per candidate and, in the score pass, the only output is 4 bytes.
// The dp pass's only large output is the L*W traceback bytes per candidate:
// each row's W bytes are one contiguous 32-byte store per warp, and the
// wrapper runs the dp pass only on the lanes that need a traceback (the
// gapless fast path synthesizes the rest), which keeps those bytes small.
// The candidate's read byte is a broadcast load, its window bytes one
// coalesced 32-byte load per row.
template <bool kTrace>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sw_kernel(const int8_t* __restrict__ reads, const int32_t* __restrict__ rlens,
          const int8_t* __restrict__ windows, uint8_t* __restrict__ tb,
          int32_t* __restrict__ score, int32_t* __restrict__ best_i,
          int32_t* __restrict__ best_b, int B, int L, int W) {
  const int lane = threadIdx.x & 31;
  const long long c =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= B) return;  // c is warp-uniform: whole warps leave together
  const bool live = lane < W;
  const int rlen = rlens[c];
  const int8_t* rrow = reads + c * L;
  const int8_t* wrow = windows + c * (long long)(L + W);
  uint8_t* tbrow = kTrace ? tb + c * (long long)L * W : nullptr;

  int Hp = live ? 0 : kNeg;
  int Ep = kNeg;
  int bs = 0, bi = 0, bb = 0;
  for (int i = 1; i <= L; ++i) {
    const int r = rrow[i - 1];
    const int w = live ? (int)wrow[i - 1 + lane] : 4;
    const int s = (r == w && r < 4) ? kMatch
                                    : ((r >= 4 || w >= 4) ? kNPen : kMismatch);
    const int M = Hp + s;
    int hu = __shfl_down_sync(kFull, Hp, 1);
    int eu = __shfl_down_sync(kFull, Ep, 1);
    if (lane + 1 >= W) {
      hu = kNeg;
      eu = kNeg;
    }
    const int e_open = hu - (kGapOpen + kGapExt);
    const int e_ext = eu - kGapExt;
    const int E = max(e_open, e_ext);
    const int Hno = max(max(M, E), 0);
    int G = Hno - kGapOpen;
    for (int sh = 1; sh < W; sh <<= 1) {
      const int t = __shfl_up_sync(kFull, G, sh);
      if (lane >= sh) G = max(G, t - kGapExt * sh);
    }
    int gl = __shfl_up_sync(kFull, G, 1);
    int hl = __shfl_up_sync(kFull, Hno, 1);
    if (lane == 0) {
      gl = kNeg;
      hl = kNeg;
    }
    const int F = gl - kGapExt;
    const int H = max(Hno, F);
    if (kTrace && live) {
      const int f_open = hl - (kGapOpen + kGapExt);
      const int choice = H == 0 ? 0 : (M == H ? 1 : (E == H ? 2 : 3));
      tbrow[(long long)(i - 1) * W + lane] = (uint8_t)(
          choice | ((e_ext > e_open) << 2) | ((F > f_open) << 3));
    }
    if (i <= rlen) {  // warp-uniform: rows past the read are not tracked
      const int hm = live ? H : kNeg;
      const int row_best = __reduce_max_sync(kFull, hm);
      // strictly greater: the first row reaching the best keeps it
      if (row_best > bs) {
        bs = row_best;
        if (kTrace) {
          bi = i;
          bb = __ffs(__ballot_sync(kFull, live && hm == row_best)) - 1;
        }
      }
    }
    Hp = live ? H : kNeg;
    Ep = live ? E : kNeg;
  }
  if (lane == 0) {
    score[c] = bs;
    if (kTrace) {
      best_i[c] = bi;
      best_b[c] = bb;
    }
  }
}

// sw_traceback_kernel.
//
// Replaces aligngraph_tpu/ops/banded_sw_pallas.py:_tb_kernel, with the
// semantics of the walk in ops/banded_sw.py:sw_traceback (step_once).
//
// Design: one thread per candidate runs the H/E/F state machine from
// (best_i, best_b) until it stops, leaves the band or passes row 1, with
// the plain walk's step budget (a path needs fewer moves, so the budget is
// never what ends a walk).  A diag move at row i writes
// g0 + (i-1) + b - pad to read base i-1; the row is pre-filled with -1.
//
// What bounds it on this card: latency of the dependent byte loads along
// the path (one tb byte per move, ~L moves per lane), not bandwidth: a
// walk reads about L of the L*W bytes its lane's dp pass wrote, mostly
// still in L2.  Its lanes are only those the gapless fast path could not
// synthesize, so the launch is small; a later version may fuse it into the
// dp pass so the bytes never leave the SM.
__global__ void sw_traceback_kernel(const uint8_t* __restrict__ tb,
                                    const int32_t* __restrict__ best_i,
                                    const int32_t* __restrict__ best_b,
                                    const int32_t* __restrict__ g0,
                                    int32_t* __restrict__ pos_map, int B,
                                    int L, int W, int pad, int max_steps) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= B) return;
  int32_t* pm = pos_map + c * L;
  for (int j = 0; j < L; ++j) pm[j] = -1;
  const uint8_t* t = tb + c * (long long)L * W;
  const int gbase = g0[c] - pad;
  int i = best_i[c];
  int b = best_b[c];
  int phase = 0;  // 0 in H, 1 in E (read gap), 2 in F (genome gap)
  for (int step = 0; step < max_steps; ++step) {
    if (i < 1 || b < 0 || b >= W) break;
    const int byte = t[(long long)(i - 1) * W + b];
    if (phase == 0) {
      const int choice = byte & 3;
      if (choice == 0) break;
      if (choice == 1) {
        pm[i - 1] = gbase + (i - 1) + b;
        --i;
      } else {
        phase = choice == 2 ? 1 : 2;
      }
    } else if (phase == 1) {
      --i;
      ++b;
      phase = ((byte >> 2) & 1) ? 1 : 0;
    } else {
      --b;
      phase = ((byte >> 3) & 1) ? 2 : 0;
    }
  }
}

inline int blocks_for(long long n, int per_block) {
  return (int)((n + per_block - 1) / per_block);
}

// Makes `device` current for the life of the guard and then restores the
// caller's device, so a launch on another card leaves the caller's (and
// torch's) current device as it was.
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

int ag_sw_score(const int8_t* reads, const int32_t* rlens,
                const int8_t* windows, int32_t* score, int B, int L, int W,
                int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  sw_kernel<false><<<blocks_for(B, kWarpsPerBlock), kWarpsPerBlock * 32, 0,
                     (cudaStream_t)stream>>>(reads, rlens, windows, nullptr,
                                             score, nullptr, nullptr, B, L,
                                             W);
  return (int)cudaGetLastError();
}

int ag_sw_dp(const int8_t* reads, const int32_t* rlens, const int8_t* windows,
             uint8_t* tb, int32_t* score, int32_t* best_i, int32_t* best_b,
             int B, int L, int W, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  sw_kernel<true><<<blocks_for(B, kWarpsPerBlock), kWarpsPerBlock * 32, 0,
                    (cudaStream_t)stream>>>(reads, rlens, windows, tb, score,
                                            best_i, best_b, B, L, W);
  return (int)cudaGetLastError();
}

int ag_sw_traceback(const uint8_t* tb, const int32_t* best_i,
                    const int32_t* best_b, const int32_t* g0,
                    int32_t* pos_map, int B, int L, int W, int pad,
                    int max_steps, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  constexpr int kThreads = 128;
  sw_traceback_kernel<<<blocks_for(B, kThreads), kThreads, 0,
                        (cudaStream_t)stream>>>(tb, best_i, best_b, g0,
                                                pos_map, B, L, W, pad,
                                                max_steps);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
//   windows [B, L + W]  int8   windows[c, x] = genome[g0 - pad + x], codes
//                              0-4 (4 outside the genome)
//   tb      [B, L, W]   uint8  one traceback byte per (row, band) cell
//   pos_map [B, L]      int32
//
// Every entry point makes `device` current for the launch and restores the
// caller's device after it, launches on the caller's stream (a stream of
// that device), allocates nothing, does not synchronise, and returns the
// first error of selecting the device, of setting up or of its launch.

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

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

// sw_dp_kernel.
//
// Replaces aligngraph_tpu/ops/banded_sw_pallas.py:_kernel (the DP with
// traceback bytes and the best cell).
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
// shuffles and ~60 integer ops per row per warp); its only large output is
// the L*W traceback bytes per candidate: each row's W bytes are one
// contiguous 32-byte store per warp, and the wrapper runs the dp pass only
// on the lanes that need a traceback (the gapless fast path synthesizes the
// rest), which keeps those bytes small.  The candidate's read byte is a
// broadcast load, its window bytes one coalesced 32-byte load per row.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sw_dp_kernel(const int8_t* __restrict__ reads,
             const int32_t* __restrict__ rlens,
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
  uint8_t* tbrow = tb + c * (long long)L * W;

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
    if (live) {
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
        bi = i;
        bb = __ffs(__ballot_sync(kFull, live && hm == row_best)) - 1;
      }
    }
    Hp = live ? H : kNeg;
    Ep = live ? E : kNeg;
  }
  if (lane == 0) {
    score[c] = bs;
    best_i[c] = bi;
    best_b[c] = bb;
  }
}

// sw_score_kernel.
//
// Replaces aligngraph_tpu/ops/banded_sw_pallas.py:_kernel_score (the
// score-only DP).
//
// What bounds it on this card: integer operations.  Its inputs are L + (L+W)
// bytes per candidate and its output 4 bytes, so it is about ten integer
// operations per band cell (the recurrence: substitution, M, E, Hno, the
// in-row F, H, the running best) against 132 SMs x 64 INT32 lanes.  With
// one cell a lane, the layout costs several times that in shuffles, scan
// steps and selects, on a chain of dependent shuffles per row.
//
// Design: a group of G lanes holds one candidate, C consecutive band cells
// a lane (cell b = g*C + k), so one warp carries 32/G candidates (W 32 and
// many candidates: C 8, G 4, 8 candidates a warp; default_cells picks C
// per launch).  Per row and lane:
//  - "up" (E) of cells k < C-1 is the lane's own cell k+1; cell C-1 takes
//    the next lane's cell 0 by one __shfl_down_sync each of H and E.
//  - E is carried as Et = E + i, which turns E = max(Hup - 3, Eup - 1)
//    into one DPX add-max, Et = max(Hup + (i - 3), Et_up); Hno = max(M,
//    Et - i, 0) is one more (__viaddmax_s32_relu).
//  - the in-row F: within the lane it runs serially as
//    F[b] = max(F[b-1] - 1, Hno[b-1] - 3), which equals the log-step
//    max-decay scan because F[b-1] - 3 < F[b-1] - 1; carried as
//    Rt[k] = R[k] + k it is one add-max a cell.  Across the group one
//    __shfl_up_sync and a log2(G)-step max-plus scan with decay C per lane
//    give the F entering the lane's first cell.  H = max(Hno, F) is one
//    add-max more.
//  - the substitution score is a signed 4-bit field of a per-row 20-bit
//    table, picked by the cell's window code: a shift pair.
//  - the score is the largest H over rows i <= rlen, which needs no row
//    order: each lane keeps its running max and the group reduces it once,
//    at the end.  A warp stops after the largest rlen of its candidates.
// kFit: C * G == W.  Otherwise (other band widths, C = 1, G = 32) cells
// b >= W are dead and held at kNeg, so they feed no live cell.
static_assert(kMatch == 2 && kMismatch == -3 && kNPen == -1,
              "the substitution table below holds these scores");

template <int C, int G, bool kFit>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sw_score_kernel(const int8_t* __restrict__ reads,
                const int32_t* __restrict__ rlens,
                const int8_t* __restrict__ windows,
                int32_t* __restrict__ score, int B, int L, int W) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: 2^k <= 32");
  constexpr int kPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  const int g = lane % G;
  const long long c =
      ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) *
          kPerWarp + lane / G;
  // lanes past B stay for the shuffles, on candidate B-1 with no rows
  const bool valid = c < B;
  const long long cc = valid ? c : B - 1;
  const int rl = valid ? min(max(rlens[cc], 0), L) : 0;
  const int rmax = __reduce_max_sync(kFull, rl);
  const int8_t* rrow = reads + cc * L;
  const int8_t* wrow = windows + cc * (long long)(L + W);
  const int b0 = g * C;

  bool live[C];
  int H[C], Et[C], sh[C];  // sh: 28 - 4 * (window code of the cell's row)
#pragma unroll
  for (int k = 0; k < C; ++k) {
    live[k] = kFit || b0 + k < W;
    H[k] = live[k] ? 0 : kNeg;
    Et[k] = kNeg;
    sh[k] = 28 - 4 * (live[k] ? (int)wrow[b0 + k] : 4);
  }
  int best = 0;
  for (int i = 1; i <= rmax; ++i) {
    const int r = rrow[i - 1];
    // nibble w of T is s(r, w) as a signed 4-bit value: 2 (match), -3
    // (mismatch, 0xD), -1 (either code 4, 0xF)
    const unsigned T =
        r < 4 ? 0xFDDDDu ^ (0xFu << (4 * r)) : 0xFFFFFu;
    int hu = __shfl_down_sync(kFull, H[0], 1, G);
    int eu = __shfl_down_sync(kFull, Et[0], 1, G);
    if (g == G - 1) {  // cell b + 1 = C * G is out of the band
      hu = kNeg;
      eu = kNeg;
    }
    int Etn[C], Hno[C], Rt[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int hup = k + 1 < C ? H[k + 1] : hu;
      const int eup = k + 1 < C ? Et[k + 1] : eu;
      Etn[k] = __viaddmax_s32(hup, i - (kGapOpen + kGapExt), eup);
      const int s = (int)(T << sh[k]) >> 28;
      Hno[k] = __viaddmax_s32_relu(Etn[k], -i, H[k] + s);
      Rt[k] = k == 0 ? Hno[0] - (kGapOpen + kGapExt)
                     : __viaddmax_s32(Hno[k], k - (kGapOpen + kGapExt),
                                      Rt[k - 1]);
    }
    // F entering cell b0: max over earlier lanes h of their R[C-1] less
    // C per lane between
    int v = __shfl_up_sync(kFull, Rt[C - 1] - (C - 1), 1, G);
    if (g == 0) v = kNeg;
#pragma unroll
    for (int s = 1; s < G; s <<= 1) {
      const int t = __shfl_up_sync(kFull, v, s, G);
      if (g >= s) v = __viaddmax_s32(t, -C * s, v);
    }
    int rowmax = kNeg;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int fk = k == 0 ? v : __viaddmax_s32(Rt[k - 1], 1, v);  // F + k
      int h = __viaddmax_s32(fk, -k, Hno[k]);
      int e = Etn[k];
      if (!kFit && !live[k]) {
        h = kNeg;
        e = kNeg;
      }
      rowmax = max(rowmax, h);
      H[k] = h;
      Et[k] = e;
    }
    if (i <= rl) best = max(best, rowmax);
    // the next row's window codes: cell k takes cell k+1's, cell C-1 one
    // new byte (index i + b; at most L + W - 1 for a live cell)
#pragma unroll
    for (int k = 0; k + 1 < C; ++k) sh[k] = sh[k + 1];
    sh[C - 1] = 28 - 4 * (live[C - 1] && i < L ? (int)wrow[i + b0 + C - 1]
                                                 : 4);
  }
#pragma unroll
  for (int s = G / 2; s > 0; s >>= 1)
    best = max(best, __shfl_xor_sync(kFull, best, s, G));
  if (valid && g == 0) score[c] = best;
}

// sw_traceback_kernel.
//
// Replaces aligngraph_tpu/ops/banded_sw_pallas.py:_tb_kernel, with the
// semantics of the walk in ops/banded_sw.py:sw_traceback (step_once).
//
// What bounds it on this card: bytes.  A walk reads the tb rows up to its
// best_i (best_i * W bytes) and writes L pos_map words.  In the way are
// the walk's ~L dependent moves, each a 1-byte load (at L2 or HBM latency
// if read from global memory), and the pos_map rows, strided by 4L bytes
// between candidates.
//
// Design: one warp per candidate, several warps a block, each warp walking
// candidate after candidate.  The warp stages the candidate's first best_i
// rows of tb into its shared memory with cp.async (16-byte copies,
// coalesced; for W 32 a row is one 32-byte sector), and while it walks one
// candidate the next one's rows load into its second buffer.  The walk is
// the exact H/E/F state machine with the plain walk's step budget, run by
// all 32 lanes in lockstep on the same state.  In the H state the lanes
// look 32 rows ahead on the current band at once: lane l reads row
// i-1-l, a ballot finds the first that is not a diag move, and up to 32
// diag moves are taken in one step (capped by the budget), each lane
// writing its own read base.  E and F moves are taken one at a time.  The
// pos_map row is built in shared memory (-1 first) and written out
// coalesced.  Where two buffers do not fit (long L) the warp uses one, and
// where one does not fit it walks tb and writes pos_map in global memory.
constexpr int kTbWarpsMax = 8;

__device__ __forceinline__ void tb_walk(const uint8_t* t, int32_t* pm, int i,
                                        int b, int W, int gbase,
                                        int max_steps, int lane) {
  int phase = 0;  // 0 in H, 1 in E (read gap), 2 in F (genome gap)
  int step = 0;
  while (step < max_steps) {
    if (i < 1 || b < 0 || b >= W) break;
    if (phase == 0) {
      const int row = i - 1 - lane;
      const int byte = row >= 0 ? (int)t[row * W + b] : 0;
      const unsigned stop = __ballot_sync(kFull, row < 0 || (byte & 3) != 1);
      int n = stop ? __ffs(stop) - 1 : 32;  // diag moves in a row
      n = min(n, max_steps - step);
      if (lane < n) pm[row] = gbase + row + b;
      i -= n;
      step += n;
      if (n == 32 || step >= max_steps || i < 1) continue;
      // the move after the run: lane n's byte, not a diag move
      const int choice = __shfl_sync(kFull, byte, n) & 3;
      ++step;
      if (choice == 0) break;
      phase = choice == 2 ? 1 : 2;
    } else {
      const int byte = t[(i - 1) * W + b];
      if (phase == 1) {
        --i;
        ++b;
        phase = ((byte >> 2) & 1) ? 1 : 0;
      } else {
        --b;
        phase = ((byte >> 3) & 1) ? 2 : 0;
      }
      ++step;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// Copies the first `rows` rows (rows * W bytes) of a candidate's tb into
// dst: 16-byte cp.async copies where `async_copy` (the wrapper checked the
// alignment: L * W % 16 == 0 and a 16-byte aligned tb), else plain byte
// loads and stores.
__device__ __forceinline__ void tb_stage(uint8_t* dst, const uint8_t* src,
                                         int rows, int W, bool async_copy,
                                         int lane) {
  const int bytes = rows * W;
  if (async_copy) {
    for (int j = lane * 16; j < bytes; j += 32 * 16)
      cp_async16(dst + j, src + j);
  } else {
    for (int j = lane; j < bytes; j += 32) dst[j] = src[j];
  }
}

__global__ void __launch_bounds__(kTbWarpsMax * 32)
sw_traceback_kernel(const uint8_t* __restrict__ tb,
                    const int32_t* __restrict__ best_i,
                    const int32_t* __restrict__ best_b,
                    const int32_t* __restrict__ g0,
                    int32_t* __restrict__ pos_map, int B, int L, int W,
                    int pad, int max_steps, int nbuf, int async_copy) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const long long stride = (long long)gridDim.x * wpb;
  long long c = (long long)blockIdx.x * wpb + warp;
  const long long cand_bytes = (long long)L * W;

  if (nbuf == 0) {  // no staging: walk tb and build pos_map in global
    for (; c < B; c += stride) {
      int32_t* pm = pos_map + c * L;
      for (int j = lane; j < L; j += 32) pm[j] = -1;
      __syncwarp();
      tb_walk(tb + c * cand_bytes, pm, min(best_i[c], L), best_b[c], W,
              g0[c] - pad, max_steps, lane);
      __syncwarp();
    }
    return;
  }

  const int buf_bytes = round16(L * W);
  uint8_t* base = smem + (long long)warp * (nbuf * buf_bytes + round16(4 * L));
  int32_t* pm_s = reinterpret_cast<int32_t*>(base + nbuf * buf_bytes);
  const bool async_copy_ok = async_copy != 0;
  if (c < B)
    tb_stage(base, tb + c * cand_bytes, min(max(best_i[c], 0), L), W,
             async_copy_ok, lane);
  cp_async_commit();
  for (int k = 0; c < B; c += stride, ++k) {
    const long long next = c + stride;
    const int cur = nbuf == 2 ? (k & 1) : 0;
    if (nbuf == 2) {
      // the other buffer was last read by the previous walk, which ended
      // with __syncwarp
      if (next < B)
        tb_stage(base + (cur ^ 1) * buf_bytes, tb + next * cand_bytes,
                 min(max(best_i[next], 0), L), W, async_copy_ok, lane);
      cp_async_commit();
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    for (int j = lane; j < L; j += 32) pm_s[j] = -1;
    __syncwarp();  // every lane's copies and -1s are visible to the warp
    tb_walk(base + cur * buf_bytes, pm_s, min(best_i[c], L), best_b[c], W,
            g0[c] - pad, max_steps, lane);
    __syncwarp();
    int32_t* pm = pos_map + c * L;
    if ((L & 3) == 0) {  // 16-byte stores: c * L * 4 is 16-byte aligned
      const int4* src = reinterpret_cast<const int4*>(pm_s);
      int4* dst = reinterpret_cast<int4*>(pm);
      for (int j = lane; j < L / 4; j += 32) dst[j] = src[j];
    } else {
      for (int j = lane; j < L; j += 32) pm[j] = pm_s[j];
    }
    __syncwarp();  // pm_s and the buffer are free again
    if (nbuf == 1 && next < B) {
      tb_stage(base, tb + next * cand_bytes, min(max(best_i[next], 0), L),
               W, async_copy_ok, lane);
      cp_async_commit();
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

// What the launchers need to know of a device, queried once per device
// (the launches come from several host threads, hence the lock).
struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;  // shared memory a block may opt in to
};

// The traceback launch for one (L, W): buffers per warp (2, 1 or 0), warps
// per block, dynamic shared memory and resident blocks on the card.
struct TbPlan {
  int nbuf = 0;
  int wpb = 0;
  int smem = 0;
  int resident = 0;
};

constexpr int kMaxDevices = 64;
std::mutex g_dev_mu;
DeviceInfo g_dev[kMaxDevices];
bool g_dev_ready[kMaxDevices] = {};
std::map<std::pair<int, int>, TbPlan> g_tb_plans[kMaxDevices];

// Call with g_dev_mu held and `device` current.
int device_info_locked(int device, DeviceInfo* out) {
  if (device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  if (!g_dev_ready[device]) {
    DeviceInfo d;
    int err;
    if ((err = (int)cudaDeviceGetAttribute(
             &d.sms, cudaDevAttrMultiProcessorCount, device)))
      return err;
    if ((err = (int)cudaDeviceGetAttribute(
             &d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)))
      return err;
    if ((err = (int)cudaFuncSetAttribute(
             sw_traceback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             d.smem_optin)))
      return err;
    g_dev[device] = d;
    g_dev_ready[device] = true;
  }
  *out = g_dev[device];
  return 0;
}

int device_info(int device, DeviceInfo* out) {
  std::lock_guard<std::mutex> lock(g_dev_mu);
  return device_info_locked(device, out);
}

// Two buffers of L*W bytes and the pos_map row per warp where they fit,
// else one, else none (the walk then stays in global memory).
int tb_plan(int device, int L, int W, TbPlan* out) {
  std::lock_guard<std::mutex> lock(g_dev_mu);
  DeviceInfo d;
  int err = device_info_locked(device, &d);
  if (err) return err;
  auto& plans = g_tb_plans[device];
  const auto key = std::make_pair(L, W);
  const auto it = plans.find(key);
  if (it != plans.end()) {
    *out = it->second;
    return 0;
  }
  const long long buf = ((long long)L * W + 15) / 16 * 16;
  const long long pmb = (4LL * L + 15) / 16 * 16;
  TbPlan plan;
  plan.wpb = kTbWarpsMax;
  for (int n = 2; n >= 1; --n) {
    const long long per_warp = n * buf + pmb;
    if (per_warp <= d.smem_optin) {
      plan.nbuf = n;
      plan.wpb = (int)(d.smem_optin / per_warp < kTbWarpsMax
                           ? d.smem_optin / per_warp
                           : kTbWarpsMax);
      plan.smem = (int)(plan.wpb * per_warp);
      break;
    }
  }
  int per_sm = 0;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, sw_traceback_kernel, plan.wpb * 32, plan.smem)))
    return err;
  plan.resident = (per_sm > 0 ? per_sm : 1) * d.sms;
  plans[key] = plan;
  *out = plan;
  return 0;
}

template <int C, int G, bool kFit>
int launch_score(const int8_t* reads, const int32_t* rlens,
                 const int8_t* windows, int32_t* score, int B, int L, int W,
                 cudaStream_t stream) {
  constexpr int kPerBlock = kWarpsPerBlock * 32 / G;
  sw_score_kernel<C, G, kFit><<<blocks_for(B, kPerBlock),
                                kWarpsPerBlock * 32, 0, stream>>>(
      reads, rlens, windows, score, B, L, W);
  return (int)cudaGetLastError();
}

// Cells per lane when the caller leaves it to the kernel: the most that
// still gives every SM kScoreWarpsPerSm warps.  More cells a lane cost
// fewer operations a cell; more warps hide more of a row's chain of
// dependent shuffles when there are few candidates.  chip_smoke.py times
// every layout; on an H100 at W 32, C 8 was the fastest from 8,192 lanes
// on and C 2 at 2,048.
constexpr int kScoreWarpsPerSm = 7;

int default_cells(int W, long long B, int sms) {
  if (W != 16 && W != 32) return 1;
  for (int c = 8; c > 1; c >>= 1) {
    const long long warps = (B * W + 32 * c - 1) / (32 * c);
    if (warps >= (long long)kScoreWarpsPerSm * sms) return c;
  }
  return 1;
}

int sw_score(const int8_t* reads, const int32_t* rlens, const int8_t* windows,
             int32_t* score, int B, int L, int W, int cells, int device,
             void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const cudaStream_t s = (cudaStream_t)stream;
  if (cells == 0) {
    DeviceInfo d;
    const int err = device_info(device, &d);
    if (err) return err;
    cells = default_cells(W, B, d.sms);
  }
  if (W == 32) {
    switch (cells) {
      case 1: return launch_score<1, 32, true>(reads, rlens, windows, score,
                                               B, L, W, s);
      case 2: return launch_score<2, 16, true>(reads, rlens, windows, score,
                                               B, L, W, s);
      case 4: return launch_score<4, 8, true>(reads, rlens, windows, score,
                                              B, L, W, s);
      case 8: return launch_score<8, 4, true>(reads, rlens, windows, score,
                                              B, L, W, s);
    }
  } else if (W == 16) {
    switch (cells) {
      case 1: return launch_score<1, 16, true>(reads, rlens, windows, score,
                                               B, L, W, s);
      case 2: return launch_score<2, 8, true>(reads, rlens, windows, score,
                                              B, L, W, s);
      case 4: return launch_score<4, 4, true>(reads, rlens, windows, score,
                                              B, L, W, s);
      case 8: return launch_score<8, 2, true>(reads, rlens, windows, score,
                                              B, L, W, s);
    }
  } else if (W >= 1 && W <= 32 && cells == 1) {
    return launch_score<1, 32, false>(reads, rlens, windows, score, B, L, W,
                                      s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int ag_sw_score(const int8_t* reads, const int32_t* rlens,
                const int8_t* windows, int32_t* score, int B, int L, int W,
                int device, void* stream) {
  return sw_score(reads, rlens, windows, score, B, L, W, 0, device, stream);
}

// ag_sw_score with the cells per lane named: 1, 2, 4 or 8 for W 16 and 32,
// 1 for other widths; 0 leaves it to the kernel.  For measuring the
// layouts.
int ag_sw_score_cells(const int8_t* reads, const int32_t* rlens,
                      const int8_t* windows, int32_t* score, int B, int L,
                      int W, int cells, int device, void* stream) {
  return sw_score(reads, rlens, windows, score, B, L, W, cells, device,
                  stream);
}

int ag_sw_dp(const int8_t* reads, const int32_t* rlens, const int8_t* windows,
             uint8_t* tb, int32_t* score, int32_t* best_i, int32_t* best_b,
             int B, int L, int W, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  sw_dp_kernel<<<blocks_for(B, kWarpsPerBlock), kWarpsPerBlock * 32, 0,
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
  TbPlan plan;
  const int err = tb_plan(device, L, W, &plan);
  if (err) return err;
  const int blocks = blocks_for(B, plan.wpb) < plan.resident
                         ? blocks_for(B, plan.wpb)
                         : plan.resident;
  const int async_copy =
      ((long long)L * W) % 16 == 0 && ((uintptr_t)tb & 15) == 0;
  sw_traceback_kernel<<<blocks, plan.wpb * 32, plan.smem,
                        (cudaStream_t)stream>>>(
      tb, best_i, best_b, g0, pos_map, B, L, W, pad, max_steps, plan.nbuf,
      async_copy);
  return (int)cudaGetLastError();
}

}  // extern "C"

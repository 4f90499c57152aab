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

// sw_dp_kernel.
//
// Replaces aligngraph_tpu/ops/banded_sw_pallas.py:_kernel (the DP with
// traceback bytes and the best cell).
//
// What bounds it on this card: integer operations.  Every row's traceback
// bytes are an output, so it runs all L rows of every candidate: the
// recurrence's ~10 operations a cell plus the byte's, against L*W bytes
// written a candidate (33.5 MB at L 512 and 2,048 lanes, 0.010 ms of
// device memory).  With few candidates, what shows is a row's chain of
// dependent shuffles and add-maxes, and the operations one warp issues
// per row.
//
// Design: sw_score_kernel's layout (C cells a lane, G lanes a candidate,
// 32/G candidates a warp; default_dp_cells picks C per launch) and forms:
//  - E carried as Et = E + i: one add-max a cell.  The top cell's "up" is
//    outside the band; a decay of kFar takes it out, and the top cell's
//    Et stays kNeg.
//  - the in-row F carried as F + 3 (S[k] = max(S[k-1] - 1, Hno[k]) in the
//    lane), joined across the group by one __shfl_up_sync and a
//    log2(G)-step max-plus scan with decay C per lane.  At C 1 the scan
//    runs inclusive, giving F of the next cell, and H = max(Hno, that
//    F + 1) needs no shift: one shuffle less on the row's chain.
//  - the traceback byte from values the recurrence holds: the choice from
//    the true M, E (Et - i) and H, as two bits of three compares with no
//    branch; E-extend as Et_up - Hup > i - 3 (a tie is an open);
//    F-extend as F > Hno[b-1] - 3, from the previous lane by one
//    __shfl_up_sync off the chain.  A lane's C bytes are packed in
//    registers and written with one C-byte store; a candidate's row stays
//    one contiguous W-byte segment.
//  - the best cell reduced once, not per row: each lane keeps the key
//    H * 32 + 31 - b of its best cell, replaced only by a row (i <= rlen)
//    whose largest key has a strictly larger H, so it keeps the first row
//    and, in it, the lowest band.  At the end the group reduces by (score
//    desc, row asc, band asc).  That is the plain rule: the final score is
//    first reached in one row, and a lane reaching it later has a larger
//    row.  Rows past rlen are masked per lane, so candidates of different
//    lengths share a warp with no branch.
//  - no loads on the row chain: the read and window bytes of the next
//    kAhead rows load while the current kAhead rows run, with no bounds
//    while the next block lies inside the read, and blocks of kAhead rows
//    run with no branch between rows.
// Left of the band F = NEG - 1 and Hno = NEG, as in the plain version.
constexpr int kAhead = 8;

constexpr int kFar = -(1 << 30);  // a decay that no scan value survives

// The substitution scores of read code r (0-4) as a 20-bit table: nibble w
// is s(r, w) as a signed 4-bit value, 2 (match), -3 (mismatch, 0xD), -1
// (either code 4, 0xF); as in sw_score_kernel.
__constant__ unsigned kSubstTable[5] = {0xFDDD2u, 0xFDD2Du, 0xFD2DDu,
                                        0xF2DDDu, 0xFFFFFu};

// One C-byte store of a lane's packed bytes (lo: cells 0-3, hi: 4-7).
template <int C>
__device__ __forceinline__ void store_bytes(uint8_t* p, unsigned lo,
                                            unsigned hi) {
  if constexpr (C == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
  } else if constexpr (C == 4) {
    *reinterpret_cast<unsigned*>(p) = lo;
  } else if constexpr (C == 2) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)lo;
  } else {
    *p = (uint8_t)lo;
  }
}

template <int C, int G, bool kFit>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sw_dp_kernel(const int8_t* __restrict__ reads,
             const int32_t* __restrict__ rlens,
             const int8_t* __restrict__ windows, uint8_t* __restrict__ tb,
             int32_t* __restrict__ score, int32_t* __restrict__ best_i,
             int32_t* __restrict__ best_b, int B, int L, int W) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: 2^k <= 32");
  static_assert(C == 1 || C == 2 || C == 4 || C == 8, "C: 1, 2, 4 or 8");
  constexpr int kPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  const int g = lane % G;
  const long long c =
      ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) *
          kPerWarp + lane / G;
  // lanes past B run candidate B-1 for the shuffles and store nothing
  const bool valid = c < B;
  const long long cc = valid ? c : B - 1;
  const int rl = valid ? rlens[cc] : 0;
  const int8_t* rrow = reads + cc * L;
  const int8_t* wrow = windows + cc * (long long)(L + W);
  const int b0 = g * C;
  const bool top = b0 + C >= W;  // cell b0 + C is out of the band
  const bool store = valid && (kFit || b0 < W);
  uint8_t* trow = tb + cc * (long long)L * W + b0;  // the next row's bytes
  // the scan's decay per step: C * s per lane, or (from a lane outside the
  // group, whose shuffle returns the lane's own value) so much that the
  // add-max keeps the lane's value
  int decay[5];
#pragma unroll
  for (int j = 0, s = 1; j < 5; ++j, s <<= 1)
    decay[j] = g >= s ? -C * s : kFar;

  bool live[C];
  int H[C], Et[C], sh[C];  // sh: 28 - 4 * (window code of the cell's row)
#pragma unroll
  for (int k = 0; k < C; ++k) {
    live[k] = kFit || b0 + k < W;
    H[k] = live[k] ? 0 : kNeg;
    Et[k] = kNeg;
    sh[k] = 28 - 4 * (live[k] ? (int)wrow[b0 + k] : 4);
  }
  // the window byte of the last cell (dead lanes: of the band's last cell)
  const uint8_t* wlast =
      reinterpret_cast<const uint8_t*>(wrow) + min(b0 + C - 1, W - 1);
  const uint8_t* rbyte = reinterpret_cast<const uint8_t*>(rrow);
  // the lane's best cell: key H * 32 + 31 - b and its row (C 1: the band
  // is the lane's, so the key is H alone until the end)
  int bkey = C == 1 ? 0 : 31, bi = 0;

  // row i from its substitution table T (kSubstTable of its read code)
  // and the last cell's window code of row i+1
  auto row = [&](const int i, const unsigned T, const int wnext) {
    const int hu = __shfl_down_sync(kFull, H[0], 1, G);
    int eu = __shfl_down_sync(kFull, Et[0], 1, G);
    // the top cell's "up" is outside the band: kFar takes hu out of its
    // E, and eu is kNeg (C 1: the lane's own or a dead lane's Et, kNeg
    // already), so its Et stays kNeg
    if (C > 1 && top) eu = kNeg;
    const int xoff = top ? kFar : i - (kGapOpen + kGapExt);
    int Etn[C], Hno[C], S[C], M[C];
    bool eb[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const bool last = k + 1 == C;
      const int hup = last ? hu : H[k + 1];
      const int eup = last ? eu : Et[k + 1];
      Etn[k] = __viaddmax_s32(hup, last ? xoff : i - (kGapOpen + kGapExt),
                              eup);
      // e_ext > e_open (at the top cell NEG - 1 > NEG - 3)
      eb[k] = (last && top) || eup - hup > i - (kGapOpen + kGapExt);
      const int s = (int)(T << sh[k]) >> 28;
      M[k] = H[k] + s;
      Hno[k] = __viaddmax_s32_relu(Etn[k], -i, M[k]);
      // F + 3 of the next cell from this lane's cells
      S[k] = k == 0 ? Hno[0] : __viaddmax_s32(S[k - 1], -1, Hno[k]);
    }
    // v: F + 3 entering the lane's first cell (C > 1), or of the cell
    // after it (C 1: the scan runs inclusive, which needs no shift, and
    // H = max(Hno, F of the next cell + 1)); hl: Hno of the cell before
    int v = C == 1 ? S[0] : __shfl_up_sync(kFull, S[C - 1], 1, G);
    int hl = C == 1 ? 0 : __shfl_up_sync(kFull, Hno[C - 1], 1, G);
    if (C > 1 && g == 0) {
      v = kNeg + 2;  // F = NEG - 1 left of the band
      hl = kNeg;
    }
#pragma unroll
    for (int j = 0, s = 1; s < G; ++j, s <<= 1)
      v = __viaddmax_s32(__shfl_up_sync(kFull, v, s, G), decay[j], v);
    unsigned lo = 0, hi = 0;
    int rowkey = 0;
    int fb1 = 0;
    if (C == 1) {  // F > f_open of the next cell, from this one
      fb1 = __shfl_up_sync(kFull, v > Hno[0], 1, G);
      if (g == 0) fb1 = 1;
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      int h;
      unsigned fb;
      if (C == 1) {
        h = __viaddmax_s32(v, -2, Hno[0]);
        fb = fb1;
      } else {
        // F + 3 + k
        const int fk = k == 0 ? v : __viaddmax_s32(S[k - 1], k, v);
        h = __viaddmax_s32(fk, -(k + 3), Hno[k]);
        const int hprev = k == 0 ? hl : Hno[k - 1];
        fb = fk > hprev + k;  // F > f_open
      }
      // the choice, 0 if H is 0, else 1 if M is H, else 2 if E is H, else
      // 3: bit 0 is H != 0 and (M is H or E is not H), bit 1 H != 0 and M
      // is not H
      const bool nz = h != 0, is_m = M[k] == h, is_e = Etn[k] == h + i;
      const unsigned byte = (nz && (is_m || !is_e) ? 1u : 0u) |
                            (nz && !is_m ? 2u : 0u) | (eb[k] ? 4u : 0u) |
                            (fb << 3);
      if (k < 4)
        lo |= byte << (8 * k);
      else
        hi |= byte << (8 * (k - 4));
      int e = Etn[k];
      if (!kFit && !live[k]) {
        h = kNeg;
        e = kNeg;
      }
      const int key = C == 1 ? h : h * 32 - k;
      rowkey = k == 0 ? key : max(rowkey, key);
      H[k] = h;
      Et[k] = e;
    }
    if (store) store_bytes<C>(trow, lo, hi);
    trow += W;
    if (C == 1) {
      if (i <= rl && rowkey > bkey) {
        bkey = rowkey;
        bi = i;
      }
    } else {
      rowkey += 31 - b0;
      if (i <= rl && rowkey > (bkey | 31)) {
        bkey = rowkey;
        bi = i;
      }
    }
#pragma unroll
    for (int k = 0; k + 1 < C; ++k) sh[k] = sh[k + 1];
    sh[C - 1] = 28 - 4 * wnext;
  };

  // rc: substitution table of row i0 + u; wc: the last cell's window code
  // of row i0 + u + 1 (one new byte a row); rn, wn: the codes kAhead rows
  // later.  Whole blocks of kAhead rows run with no branch between rows;
  // while the next block lies inside the read (rows up to L - 1), its
  // loads need no bounds.
  unsigned rc[kAhead];
  int wc[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const int i = 1 + u;
    rc[u] = kSubstTable[i <= L ? min((int)rbyte[i - 1], 4) : 4];
    wc[u] = i < L ? wlast[i] : 4;
  }
  auto block = [&](const int i0, const bool bounded) {
    int rn[kAhead], wn[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = i0 + kAhead + u;
      rn[u] = !bounded || i <= L ? rbyte[i - 1] : 4;
      wn[u] = !bounded || i < L ? wlast[i] : 4;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) row(i0 + u, rc[u], wc[u]);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      rc[u] = kSubstTable[min(rn[u], 4)];
      wc[u] = wn[u];
    }
  };
  int i0 = 1;
  for (; i0 + 2 * kAhead <= L; i0 += kAhead) block(i0, false);
  for (; i0 + kAhead - 1 <= L; i0 += kAhead) block(i0, true);
#pragma unroll
  for (int u = 0; u + 1 < kAhead; ++u)  // the last L % kAhead rows
    if (i0 + u <= L) row(i0 + u, rc[u], wc[u]);
  if (C == 1) bkey = bi ? bkey * 32 + 31 - b0 : 31;
  int sc = bkey >> 5;
  int sec = (bi << 5) | (31 - (bkey & 31));  // row, band
#pragma unroll
  for (int s = G / 2; s > 0; s >>= 1) {
    const int osc = __shfl_xor_sync(kFull, sc, s, G);
    const int osec = __shfl_xor_sync(kFull, sec, s, G);
    if (osc > sc || (osc == sc && osec < sec)) {
      sc = osc;
      sec = osec;
    }
  }
  if (valid && g == 0) {
    score[c] = sc;
    best_i[c] = sec >> 5;
    best_b[c] = sec & 31;
  }
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

// A layout of the score and dp kernels: C cells a lane, G lanes a
// candidate; kFit: C * G == W.
template <int C_, int G_, bool kFit_>
struct Layout {
  static constexpr int C = C_;
  static constexpr int G = G_;
  static constexpr bool kFit = kFit_;
};

// launch(Layout<C, G, kFit>{}) for `cells` per lane at band width W: 1, 2,
// 4 or 8 at W 16 and 32, 1 at other widths up to 32; else
// cudaErrorInvalidValue.
template <class F>
int with_layout(int W, int cells, F launch) {
  if (W == 32) {
    switch (cells) {
      case 1: return launch(Layout<1, 32, true>{});
      case 2: return launch(Layout<2, 16, true>{});
      case 4: return launch(Layout<4, 8, true>{});
      case 8: return launch(Layout<8, 4, true>{});
    }
  } else if (W == 16) {
    switch (cells) {
      case 1: return launch(Layout<1, 16, true>{});
      case 2: return launch(Layout<2, 8, true>{});
      case 4: return launch(Layout<4, 4, true>{});
      case 8: return launch(Layout<8, 2, true>{});
    }
  } else if (W >= 1 && W <= 32 && cells == 1) {
    return launch(Layout<1, 32, false>{});
  }
  return (int)cudaErrorInvalidValue;
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

// The dp kernel's cells per lane when the caller leaves it to the kernel:
// the fewest that still run every candidate in one block per SM.  Fewer
// cells a lane give a shorter row chain and fewer operations per row for
// each warp to issue; a second block on an SM doubles what its warps
// issue per row, which costs more than more cells a lane.  chip_smoke.py
// times every layout; on an H100 at W 32 each layout's time was flat up to
// one block per SM and stepped up past it.
int default_dp_cells(int W, long long B, int sms) {
  if (W != 16 && W != 32) return 1;
  for (int c = 1; c < 8; c <<= 1)
    if (blocks_for(B, kWarpsPerBlock * 32 * c / W) <= sms) return c;
  return 8;
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
  return with_layout(W, cells, [&](auto layout) {
    using Lt = decltype(layout);
    sw_score_kernel<Lt::C, Lt::G, Lt::kFit>
        <<<blocks_for(B, kWarpsPerBlock * 32 / Lt::G), kWarpsPerBlock * 32, 0,
           s>>>(reads, rlens, windows, score, B, L, W);
    return (int)cudaGetLastError();
  });
}

int sw_dp(const int8_t* reads, const int32_t* rlens, const int8_t* windows,
          uint8_t* tb, int32_t* score, int32_t* best_i, int32_t* best_b,
          int B, int L, int W, int cells, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const cudaStream_t s = (cudaStream_t)stream;
  // C-byte stores need a tb aligned to 8 bytes (torch.empty's is)
  if (((uintptr_t)tb & 7) != 0) return (int)cudaErrorMisalignedAddress;
  if (cells == 0) {
    DeviceInfo d;
    const int err = device_info(device, &d);
    if (err) return err;
    cells = default_dp_cells(W, B, d.sms);
  }
  return with_layout(W, cells, [&](auto layout) {
    using Lt = decltype(layout);
    sw_dp_kernel<Lt::C, Lt::G, Lt::kFit>
        <<<blocks_for(B, kWarpsPerBlock * 32 / Lt::G), kWarpsPerBlock * 32, 0,
           s>>>(reads, rlens, windows, tb, score, best_i, best_b, B, L, W);
    return (int)cudaGetLastError();
  });
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
  return sw_dp(reads, rlens, windows, tb, score, best_i, best_b, B, L, W, 0,
               device, stream);
}

// ag_sw_dp with the cells per lane named, as ag_sw_score_cells: 1, 2, 4 or
// 8 for W 16 and 32, 1 for other widths; 0 leaves it to the kernel.
int ag_sw_dp_cells(const int8_t* reads, const int32_t* rlens,
                   const int8_t* windows, uint8_t* tb, int32_t* score,
                   int32_t* best_i, int32_t* best_b, int B, int L, int W,
                   int cells, int device, void* stream) {
  return sw_dp(reads, rlens, windows, tb, score, best_i, best_b, B, L, W,
               cells, device, stream);
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

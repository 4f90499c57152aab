// The contig aligner's chain DP over M-blocks, many placements at once,
// written by hand for Hopper (sm_90a).  Plain C entry points, loaded with
// ctypes by aligngraph_tpu_torch/ops/_build.py and wrapped by
// ops/monotone_chain.py (monotone_chain_cuda, which also makes the launch
// plan; the plain version is monotone_chain_plain there).
//
// Replaces host code, not a Pallas kernel: the JAX package runs this loop
// on the host, in ContigAligner._enforce_monotone
// (aligngraph_tpu/align/contig_aligner.py:185-196), and the port ran it
// in C++ (native/chain.cpp) once per placement.
//
// Semantics (native/chain.cpp's, bit for bit).  A placement's m blocks
// have target spans [t0, t1) and weights w >= 1, in query order.  best[i]
// starts at w[i]; for i = 1..m-1 the gain of j < i is best[j] + (w[i] -
// ov), ov = max(t1[j] - t0[i], 0), when that kept weight is > 0, else -1;
// j is the FIRST j of largest gain, taken when its gain is > best[i]
// (then parent[i] = j, trim[i] = ov).  keep marks the blocks on the parent
// walk from the first argmax of best.
//
// Layouts (int64 unless named, contiguous, the placements back to back):
//   t0, t1, w, best, parent, trim  [n_blocks]
//   keep                           [n_blocks] bool (a byte, 0 or 1)
//   offsets                        [n_placements + 1], placement p's
//                                  blocks are offsets[p]..offsets[p+1]-1
//   order                          [n_placements], the placements
//                                  by block count, longest first
//   lo                             [n_placements], each placement's least
//                                  t0 or t1 (the rebase)
//   scratch                        [n_blocks] rows (c, e) of the DP type,
//                                  for a cluster's placements past its
//                                  shared memory
//
// What bounds it.  A placement of m blocks does m(m-1)/2 (i, j) pairs, and
// step i needs every best[j < i], so the steps are a chain.  Its inputs
// and outputs are 49 bytes a block, far below the operations for any m
// past a few: the bound is operations, and the chain's latency where the
// pairs are few.
//
// Design.  With w >= 1 every best is >= 1, so a pair whose kept weight is
// <= 0 (gain -1) can never be taken and is dropped; the rest is written
// as x = c[j] + min(t0[i], t1[j]), c[j] = best[j] - t1[j], valid when
// t1[j] <= v[i] = t0[i] + w[i] - 1, the gain being x + w[i]: a pair costs
// about six integer operations.  Only differences of t enter, so each
// placement is rebased on its `lo`, and the wrapper proves that int32
// cannot overflow (span of t and sum of w < 2^31); otherwise the int64
// instantiation of the same template runs.
//   - The steps go in blocks of kRows = 32, a row a lane.  For block k the
//     candidates over j < 32(k-1) are independent of each other: producer
//     warps compute them while the chain warp walks block k-1 (warp
//     specialisation, one CTA barrier a block).  The chain warp then adds
//     block k-1's rows (still in its registers, by shuffles) and walks
//     block k's own rows in order, lane s finalising row s and handing its
//     (c, t1) to the later lanes by shuffles.  Candidates are combined as
//     (larger x, then smaller j), each producer keeping its first max, so
//     the reference's first-index rule holds.
//   - The rows (c, t1) live in shared memory (8 bytes a block in int32:
//     kSmemRows32 blocks a CTA, kCluster times that a cluster); only a
//     cluster's placement past that uses the scratch rows.
//   - Placements of more than kClusterFrom blocks run on a thread-block
//     cluster of kCluster CTAs: block q's rows live in CTA q % kCluster,
//     whose producers compute their share of every later block's
//     candidates and store them into the leader's shared memory; the
//     leader's chain warp walks the blocks and stores each finished row
//     into its owner (distributed shared memory), one cluster barrier a
//     block.  They are one launch; the others a second.
//   - Placements of at most kRows blocks take a warp each, kWarps to a CTA.
//   - The grid follows `order`, so the longest placements start first.
//   - Then the first argmax of best and the walk of the parents, in shared
//     memory (int32) when they fit.
// Nothing is allocated; the launches are on the caller's stream and do not
// synchronise.

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
// the DP's steps a block: one row a lane of the chain warp
constexpr int kRows = 32;
// producer warps a CTA, beside the one chain warp
constexpr int kProd = 8;
constexpr int kWarps = kProd + 1;
constexpr int kThreads = 32 * kWarps;
// CTAs a cluster (the portable most)
constexpr int kCluster = 8;
// placements of more blocks than this run on a cluster
constexpr int kClusterFrom = 4096;
// the shared memory a block may opt in to on sm_90, less room for the
// dynamic part's alignment
constexpr int kSmemBudget = 232448 - 256;
// rows (c, t1) a CTA keeps in dynamic shared memory, int32 and int64
constexpr int kSmemRows32 = 28224;
constexpr int kSmemRows64 = 13728;

// a placement on one CTA always keeps its rows in shared memory: only a
// cluster's may need the scratch rows
static_assert(kClusterFrom <= kSmemRows64, "a CTA's rows fit shared memory");

template <typename T>
struct alignas(2 * sizeof(T)) CE {
  T c;  // best - t1 (rebased)
  T e;  // t1 (rebased)
};

template <typename T>
struct Cand {
  T g;
  int j;
};

template <typename T>
struct Shared {
  // the leader's cross candidates of the next two blocks, by rank
  Cand<T> slot[2][kCluster][kRows];
  // each producer warp's candidates
  Cand<T> red[kProd][kRows];
  Cand<long long> top[kWarps];
};

template <typename T>
constexpr int smem_rows() {
  return sizeof(T) == 4 ? kSmemRows32 : kSmemRows64;
}

// the capacities are the most rows (a multiple of kRows) that fit beside
// the static shared memory
static_assert(kSmemRows32 % kRows == 0 && kSmemRows64 % kRows == 0, "");
static_assert(sizeof(Shared<int>) + kSmemRows32 * sizeof(CE<int>)
                  <= kSmemBudget &&
              sizeof(Shared<int>) + (kSmemRows32 + kRows) * sizeof(CE<int>)
                  > kSmemBudget, "kSmemRows32");
static_assert(sizeof(Shared<long long>) + kSmemRows64 * sizeof(CE<long long>)
                  <= kSmemBudget &&
              sizeof(Shared<long long>)
                  + (kSmemRows64 + kRows) * sizeof(CE<long long>)
                  > kSmemBudget, "kSmemRows64");

template <typename T>
__device__ __forceinline__ T tmin() {
  return sizeof(T) == 4 ? (T)INT_MIN : (T)LLONG_MIN;
}

template <typename T>
__device__ __forceinline__ T tmax() {
  return sizeof(T) == 4 ? (T)INT_MAX : (T)LLONG_MAX;
}

template <typename T>
__device__ __forceinline__ bool better(T g, int j, T g2, int j2) {
  return g > g2 || (g == g2 && j < j2);
}

struct Args {
  const long long* t0;
  const long long* t1;
  const long long* w;
  const long long* offsets;
  const long long* order;
  const long long* lo;
  long long* best;
  long long* parent;
  long long* trim;
  unsigned char* keep;
  void* scratch;
  int first;      // this launch's first entry of order
  int n_big;      // its placements on a CTA or a cluster each
  int n_small;    // then its placements on a warp each
  int smem_rows;  // rows (c, t1) of dynamic shared memory
};

// One row's inputs, rebased: t0, t1, w and v = t0 + w - 1 (clamped to the
// type: t1 of any j is at most the type's max, so the test is unchanged).
template <typename T>
struct Row {
  T t, e, w, v;
};

struct RawRow {
  long long t0, t1, w;
};

__device__ __forceinline__ RawRow load_row(const Args& a, long long base,
                                           int i, int m) {
  RawRow r{0, 0, 1};
  if (i < m) {
    r.t0 = __ldg(a.t0 + base + i);
    r.t1 = __ldg(a.t1 + base + i);
    r.w = __ldg(a.w + base + i);
  }
  return r;
}

template <typename T>
__device__ __forceinline__ Row<T> rebase(const RawRow& r, long long lo) {
  const long long t = r.t0 - lo;
  const long long v = t + r.w - 1;
  return {(T)t, (T)(r.t1 - lo), (T)r.w, v > (long long)tmax<T>()
                                            ? tmax<T>() : (T)v};
}

// Row j's candidate for row (t, v): (x, valid) into the running (g, j).
template <typename T>
__device__ __forceinline__ void offer(const Row<T>& row, T c, T e, int j,
                                      T& g, int& jg) {
  const T x = c + min(row.t, e);
  if (e <= row.v && x > g) {
    g = x;
    jg = j;
  }
}

// Where the rows (c, t1) of a placement live.  Shared memory: on a CTA row
// j at j; on a cluster block q's rows in CTA q % cs, at local block q / cs.
// The scratch rows (kGlobal, a cluster's placement past shared memory): row
// j at j.
template <typename T, bool kClustered, bool kGlobal>
struct Store {
  static_assert(kClustered || !kGlobal, "a CTA's rows are in shared memory");
  CE<T>* local;
  int cs;
  int rank;

  // this rank's owned row r (producers), as a global row index
  __device__ __forceinline__ int owned_j(int r) const {
    return ((r >> 5) * cs + rank) * kRows + (r & 31);
  }
  __device__ __forceinline__ const CE<T>& owned(int r) const {
    return local[kGlobal ? owned_j(r) : r];
  }
  __device__ __forceinline__ CE<T>* at(int j) const {
    if constexpr (kGlobal || !kClustered) {
      return local + j;
    } else {
      const int q = j >> 5;
      return cg::this_cluster().map_shared_rank(local, q % cs)
             + (q / cs) * kRows + (j & 31);
    }
  }
};

template <bool kClustered>
__device__ __forceinline__ void epoch_barrier() {
  if constexpr (kClustered) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ void producers_barrier() {
  asm volatile("bar.sync 1, %0;" ::"r"(kProd * 32) : "memory");
}

// The chain warp of the leader: block k's rows, lane l row 32 k + l.
template <typename T, bool kClustered, bool kGlobal>
__device__ void chain_warp(const Args& a, long long base, int m, long long lo,
                           int nb, const Store<T, kClustered, kGlobal>& st,
                           Shared<T>& sh) {
  const int lane = threadIdx.x & 31;
  RawRow next = load_row(a, base, lane, m);
  T prev_c = 0;
  T prev_e = 0;
  for (int k = 0; k < nb; ++k) {
    const Row<T> row = rebase<T>(next, lo);
    if (k + 1 < nb) next = load_row(a, base, (k + 1) * kRows + lane, m);
    const int i = k * kRows + lane;
    T g = tmin<T>();
    int j = INT_MAX;
    if (k > 0) {
      // the producers' candidates over j < 32 (k - 1)
      for (int r = 0; r < st.cs; ++r) {
        const Cand<T> c = sh.slot[k & 1][r][lane];
        if (better(c.g, c.j, g, j)) {
          g = c.g;
          j = c.j;
        }
      }
    }
    const int j_cross = j;
    T ej = 0;
    if (k > 0) {
      // block k-1's rows, all final
#pragma unroll
      for (int s = 0; s < kRows; ++s) {
        const T c = __shfl_sync(kFull, prev_c, s);
        const T e = __shfl_sync(kFull, prev_e, s);
        const T x = c + min(row.t, e);
        if (e <= row.v && x > g) {
          g = x;
          j = (k - 1) * kRows + s;
          ej = e;
        }
      }
    }
    // block k's own rows in order: lane s is final at step s
    const T wv = row.w - row.e;
    const int nrows = min(kRows, m - k * kRows);
    for (int s = 0; s < nrows; ++s) {
      const T c = __shfl_sync(kFull, max(g, (T)0) + wv, s);
      const T e = __shfl_sync(kFull, row.e, s);
      const T x = c + min(row.t, e);
      if (lane > s && e <= row.v && x > g) {
        g = x;
        j = k * kRows + s;
        ej = e;
      }
    }
    const bool taken = g > 0;
    const T b = (taken ? g : (T)0) + row.w;
    const T c = b - row.e;
    long long tr = 0;
    if (taken) {
      if (j == j_cross) {
        // b[j] - x = max(t1[j] - t0[i], 0)
        const CE<T> r = *st.at(j);
        tr = (long long)(r.c + r.e - g);
      } else {
        tr = (long long)(ej - min(ej, row.t));
      }
    }
    if (i < m) {
      a.best[base + i] = (long long)b;
      a.parent[base + i] = taken ? j : -1;
      a.trim[base + i] = tr;
      a.keep[base + i] = 0;
      *st.at(i) = CE<T>{c, row.e};
    }
    prev_c = c;
    prev_e = row.e;
    epoch_barrier<kClustered>();
  }
}

// Producer warp pw of this CTA: in epoch k, block k+1's candidates over
// this rank's rows of blocks q < k, stored into the leader's slot.
template <typename T, bool kClustered, bool kGlobal>
__device__ void producer_warp(const Args& a, long long base, int m,
                             long long lo, int nb,
                             const Store<T, kClustered, kGlobal>& st,
                             Shared<T>& sh) {
  const int lane = threadIdx.x & 31;
  const int pw = (threadIdx.x >> 5) - 1;
  RawRow next = load_row(a, base, kRows + lane, m);
  for (int k = 0; k < nb; ++k) {
    if (k + 1 < nb) {
      const Row<T> row = rebase<T>(next, lo);
      if (k + 2 < nb) next = load_row(a, base, (k + 2) * kRows + lane, m);
      const int nq = k > st.rank ? (k - st.rank + st.cs - 1) / st.cs : 0;
      const int npairs = nq * (kRows / 2);
      // two running firsts (even and odd rows) break the dependence
      T g0 = tmin<T>(), g1 = tmin<T>();
      int f0 = 0, f1 = 0;
#pragma unroll 4
      for (int f = pw; f < npairs; f += kProd) {
        const CE<T> r0 = st.owned(2 * f);
        const CE<T> r1 = st.owned(2 * f + 1);
        offer(row, r0.c, r0.e, f, g0, f0);
        offer(row, r1.c, r1.e, f, g1, f1);
      }
      T g = g0;
      int r = 2 * f0;
      if (g1 > g || (g1 == g && 2 * f1 + 1 < r)) {
        g = g1;
        r = 2 * f1 + 1;
      }
      sh.red[pw][lane] = Cand<T>{g, g == tmin<T>() ? INT_MAX : st.owned_j(r)};
      producers_barrier();
      if (pw == 0) {
        Cand<T> best = sh.red[0][lane];
        for (int q = 1; q < kProd; ++q) {
          const Cand<T> c = sh.red[q][lane];
          if (better(c.g, c.j, best.g, best.j)) best = c;
        }
        Cand<T>* dst = &sh.slot[(k + 1) & 1][st.rank][lane];
        if constexpr (kClustered) {
          dst = cg::this_cluster().map_shared_rank(dst, 0);
        }
        *dst = best;
      }
    }
    epoch_barrier<kClustered>();
  }
}

// One placement of more than kRows blocks, on this CTA (or cluster).
template <typename T, bool kClustered, bool kGlobal>
__device__ void placement(const Args& a, long long base, int m, long long lo,
                          int cs, int rank, Shared<T>& sh, CE<T>* local) {
  const int nb = (m + kRows - 1) / kRows;
  const Store<T, kClustered, kGlobal> st{local, cs, rank};
  const int warp = threadIdx.x >> 5;
  if (warp > 0) {
    producer_warp<T, kClustered, kGlobal>(a, base, m, lo, nb, st, sh);
  } else if (rank == 0) {
    chain_warp<T, kClustered, kGlobal>(a, base, m, lo, nb, st, sh);
  } else {
    for (int k = 0; k < nb; ++k) epoch_barrier<kClustered>();
  }
}

// The first argmax of best, then the walk of its parents (leader only).
template <typename T>
__device__ void keep_walk(const Args& a, long long base, int m,
                          Shared<T>& sh, int* par) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long g = LLONG_MIN;
  int j = INT_MAX;
  for (int k = threadIdx.x; k < m; k += kThreads) {
    const long long v = a.best[base + k];
    if (v > g) {
      g = v;
      j = k;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const long long g2 = __shfl_down_sync(kFull, g, o);
    const int j2 = __shfl_down_sync(kFull, j, o);
    if (better(g2, j2, g, j)) {
      g = g2;
      j = j2;
    }
  }
  if (lane == 0) sh.top[warp] = Cand<long long>{g, j};
  const bool in_smem = par != nullptr;
  if (in_smem) {
    for (int k = threadIdx.x; k < m; k += kThreads) {
      par[k] = (int)a.parent[base + k];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Cand<long long> top = sh.top[0];
    for (int w = 1; w < kWarps; ++w) {
      if (better(sh.top[w].g, sh.top[w].j, top.g, top.j)) top = sh.top[w];
    }
    if (in_smem) {
      for (int k = top.j; k >= 0; k = par[k]) a.keep[base + k] = 1;
    } else {
      for (long long k = top.j; k >= 0; k = a.parent[base + k]) {
        a.keep[base + k] = 1;
      }
    }
  }
}

// A placement of at most kRows blocks on one warp: lane l is row l.
template <typename T>
__device__ void small_placement(const Args& a, int p) {
  const int lane = threadIdx.x & 31;
  const long long base = a.offsets[p];
  const int m = (int)(a.offsets[p + 1] - base);
  const Row<T> row = rebase<T>(load_row(a, base, lane, m), a.lo[p]);
  T g = tmin<T>();
  int j = INT_MAX;
  T ej = 0;
  const T wv = row.w - row.e;
  for (int s = 0; s < m; ++s) {
    const T c = __shfl_sync(kFull, max(g, (T)0) + wv, s);
    const T e = __shfl_sync(kFull, row.e, s);
    const T x = c + min(row.t, e);
    if (lane > s && e <= row.v && x > g) {
      g = x;
      j = s;
      ej = e;
    }
  }
  const bool taken = g > 0;
  const T b = (taken ? g : (T)0) + row.w;
  const int par = taken ? j : -1;
  // the first argmax of best among the rows, then the walk by shuffles
  long long bg = lane < m ? (long long)b : LLONG_MIN;
  int bj = lane < m ? lane : INT_MAX;
  for (int o = 16; o > 0; o >>= 1) {
    const long long g2 = __shfl_xor_sync(kFull, bg, o);
    const int j2 = __shfl_xor_sync(kFull, bj, o);
    if (better(g2, j2, bg, bj)) {
      bg = g2;
      bj = j2;
    }
  }
  unsigned path = 0;
  for (int k = m > 0 ? bj : -1; k >= 0; k = __shfl_sync(kFull, par, k)) {
    path |= 1u << k;
  }
  if (lane < m) {
    a.best[base + lane] = (long long)b;
    a.parent[base + lane] = par;
    a.trim[base + lane] = taken ? (long long)(ej - min(ej, row.t)) : 0;
    a.keep[base + lane] = (path >> lane) & 1u;
  }
}

template <typename T, bool kClustered>
__global__ void __launch_bounds__(kThreads)
    monotone_chain_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Shared<T> sh;
  int cs = 1;
  int rank = 0;
  if constexpr (kClustered) {
    cs = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }
  const int task = (int)blockIdx.x / cs;
  if (task >= a.n_big) {
    if constexpr (!kClustered) {
      const int s = (task - a.n_big) * kWarps + (int)(threadIdx.x >> 5);
      if (s < a.n_small) {
        small_placement<T>(a, (int)a.order[a.first + a.n_big + s]);
      }
    }
    return;
  }
  const int p = (int)a.order[a.first + task];
  const long long base = a.offsets[p];
  const int m = (int)(a.offsets[p + 1] - base);
  const long long lo = a.lo[p];
  CE<T>* rows = reinterpret_cast<CE<T>*>(dyn);
  if constexpr (kClustered) {
    const int nb = (m + kRows - 1) / kRows;
    // every CTA of the cluster runs before any reaches another's memory
    cg::this_cluster().sync();
    if ((nb + cs - 1) / cs * kRows <= a.smem_rows) {
      placement<T, true, false>(a, base, m, lo, cs, rank, sh, rows);
    } else {
      placement<T, true, true>(a, base, m, lo, cs, rank, sh,
                               reinterpret_cast<CE<T>*>(a.scratch) + base);
    }
  } else {
    placement<T, false, false>(a, base, m, lo, cs, rank, sh, rows);
  }
  if (rank != 0) return;
  const bool par_fits =
      4LL * m <= (long long)a.smem_rows * (long long)sizeof(CE<T>);
  keep_walk<T>(a, base, m, sh, par_fits ? reinterpret_cast<int*>(dyn)
                                         : nullptr);
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

int round_rows(long long rows, int cap) {
  rows = (rows + kRows - 1) / kRows * kRows;
  return (int)(rows < cap ? rows : cap);
}

template <typename T>
int launch(Args a, int n_cluster, int n_cta, int n_warp, int max_m_cluster,
           int max_m_cta, cudaStream_t stream) {
  constexpr int cap = smem_rows<T>();
  constexpr int row_bytes = (int)sizeof(CE<T>);
  if (n_cluster > 0) {
    // a rank's rows, or the leader's int32 parents if they need more
    const long long nb = (max_m_cluster + kRows - 1) / kRows;
    const long long own = (nb + kCluster - 1) / kCluster * kRows;
    const long long walk = (4LL * max_m_cluster + row_bytes - 1) / row_bytes;
    a.first = 0;
    a.n_big = n_cluster;
    a.n_small = 0;
    a.smem_rows = round_rows(own > walk ? own : walk, cap);
    const int bytes = a.smem_rows * row_bytes;
    auto kernel = monotone_chain_kernel<T, true>;
    if (own > cap && a.scratch == nullptr) return (int)cudaErrorInvalidValue;
    int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_cluster * kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = (int)cudaLaunchKernelEx(&cfg, kernel, a);
    if (!err) err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (n_cta + n_warp > 0) {
    a.first = n_cluster;
    a.n_big = n_cta;
    a.n_small = n_warp;
    // a CTA's rows are in shared memory (the plan keeps them few enough)
    if (max_m_cta > cap) return (int)cudaErrorInvalidValue;
    a.smem_rows = n_cta > 0 ? round_rows(max_m_cta, cap) : 0;
    const int bytes = a.smem_rows * row_bytes;
    auto kernel = monotone_chain_kernel<T, false>;
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return err;
    const int grid = n_cta + (n_warp + kWarps - 1) / kWarps;
    kernel<<<grid, kThreads, bytes, stream>>>(a);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // namespace

extern "C" {

// The kernel's sizes, in this order: kRows, kSmemRows32, kSmemRows64,
// kCluster, kClusterFrom, kThreads.  Returns how many it wrote (at most n).
int ag_monotone_chain_limits(int* out, int n) {
  const int v[] = {kRows, kSmemRows32, kSmemRows64, kCluster, kClusterFrom,
                   kThreads};
  const int k = n < 6 ? n : 6;
  for (int i = 0; i < k; ++i) out[i] = v[i];
  return k;
}

// The launch plan comes from the wrapper: order[0, n_cluster) on clusters
// (largest m max_m_cluster), the next n_cta on a CTA each (largest m
// max_m_cta, at most kSmemRows64), the last n_warp (m <= kRows) on a warp
// each; wide selects int64.  scratch holds n_blocks rows of the type when a
// cluster's rows do not fit its shared memory (more than kCluster *
// kSmemRows32 or kSmemRows64 blocks; else it may be null).  Returns the
// first CUDA error of selecting the device, of checking the plan, of
// setting a kernel's attributes or of a launch.
int ag_monotone_chain(const long long* t0, const long long* t1,
                      const long long* w, const long long* offsets,
                      const long long* order, const long long* lo,
                      long long* best,
                      long long* parent, long long* trim, unsigned char* keep,
                      void* scratch, int n_cluster, int n_cta, int n_warp,
                      int max_m_cluster, int max_m_cta, int wide, int device,
                      void* stream) {
  if (n_cluster + n_cta + n_warp <= 0) return 0;
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const Args a{t0, t1, w, offsets, order, lo, best, parent, trim, keep,
               scratch, 0, 0, 0, 0};
  const cudaStream_t s = (cudaStream_t)stream;
  return wide ? launch<long long>(a, n_cluster, n_cta, n_warp, max_m_cluster,
                                  max_m_cta, s)
              : launch<int>(a, n_cluster, n_cta, n_warp, max_m_cluster,
                            max_m_cta, s);
}

}  // extern "C"

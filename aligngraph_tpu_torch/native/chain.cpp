// Weighted chain DP of ContigAligner._enforce_monotone over M-blocks
// (target span [t0, t1), weight w), with target-overlap trimming.
//
// For each block i (in query order) the predecessor is the FIRST j < i
// with the largest gain, where gain = best[j] + (w[i] - overlap) when
// that kept weight is positive, else -1; it is taken when gain > best[i]
// (which starts at w[i]).  This is the numpy loop's arithmetic and tie
// rule, one machine loop instead of one numpy call chain per block.
//
// Build: g++ -O3 -shared -fPIC (aligngraph_tpu_torch/native/__init__.py).

#include <cstdint>

extern "C" void ag_monotone_chain(int64_t m, const int64_t* t0,
                                  const int64_t* t1, const int64_t* w,
                                  int64_t* best, int64_t* parent,
                                  int64_t* trim) {
  for (int64_t i = 0; i < m; ++i) {
    best[i] = w[i];
    parent[i] = -1;
    trim[i] = 0;
  }
  for (int64_t i = 1; i < m; ++i) {
    int64_t g_max = 0, j_max = -1, ov_max = 0;
    for (int64_t j = 0; j < i; ++j) {
      int64_t ov = t1[j] - t0[i];
      if (ov < 0) ov = 0;
      const int64_t kept = w[i] - ov;
      const int64_t g = kept > 0 ? best[j] + kept : -1;
      if (j_max < 0 || g > g_max) {
        g_max = g;
        j_max = j;
        ov_max = ov;
      }
    }
    if (g_max > best[i]) {
      best[i] = g_max;
      parent[i] = j_max;
      trim[i] = ov_max;
    }
  }
}

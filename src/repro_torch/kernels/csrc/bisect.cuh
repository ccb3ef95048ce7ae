// Bisections over one sorted column, shared by the probe kernels (sm_90a).
//
// Each is run by one thread for one query.  A step is one dependent load
// through the read-only path (__ldg); the column may be empty, in which
// case nothing is read.  K is the key width (int32_t or int64_t); the
// comparison happens at that width.

#pragma once

#include <cstdint>

namespace bisect {

// #{k in keys[0:n) : k < x}  (searchsorted "left").
template <typename K>
__device__ __forceinline__ int lower_bound(const K* __restrict__ keys, int n,
                                           K x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// rank_lo = #{k < x}, rank_hi = #{k <= x}.  The two searches share their
// prefix: they only diverge at the first key equal to x, after which each
// finishes in its own half, so a hit costs about log2 n + log2(run) loads
// rather than 2 log2 n.  Exact for the dtype's max and min.
template <typename K>
__device__ __forceinline__ void equal_range(const K* __restrict__ keys, int n,
                                            K x, int& rank_lo, int& rank_hi) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const K v = __ldg(keys + mid);
    if (v < x) {
      lo = mid + 1;
    } else if (v > x) {
      hi = mid;
    } else {
      // keys[mid] == x: rank_lo lies in [lo, mid], rank_hi in [mid+1, hi]
      int ulo = mid + 1, uhi = hi;
      hi = mid;
      while (lo < hi) {  // first index with keys[.] >= x
        const int m = lo + ((hi - lo) >> 1);
        if (__ldg(keys + m) < x) lo = m + 1; else hi = m;
      }
      while (ulo < uhi) {  // first index with keys[.] > x
        const int m = ulo + ((uhi - ulo) >> 1);
        if (__ldg(keys + m) <= x) ulo = m + 1; else uhi = m;
      }
      rank_lo = lo;
      rank_hi = ulo;
      return;
    }
  }
  rank_lo = lo;
  rank_hi = lo;
}

}  // namespace bisect

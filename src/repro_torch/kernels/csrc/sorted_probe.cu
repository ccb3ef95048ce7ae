// Equal-range probe of query keys into one sorted key column (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/sorted_probe.py::
// sorted_probe_pallas (body _probe_kernel).  For sorted `keys[0:n)` and
// each query q it writes
//
//     rank_lo  = #{k : k <  q}     (searchsorted "left")
//     rank_hi  = #{k : k <= q}     (searchsorted "right")
//     contains = rank_lo < rank_hi
//
// What it computes, not how the TPU did it: the Pallas body streams the
// whole column through VMEM and broadcast-compares every tile against
// every query, because a TPU lane has no cheap gather.  An H100 thread
// does, so here each thread bisects for its own query.
//
// What bounds it on this card: a bisection over n keys is ceil(log2 n)
// *dependent* loads per query (24 for the 10M-key column), each a 32-byte
// sector fetch whose latency cannot overlap with the next step of the
// same thread.  It is latency-bound, not bandwidth-bound; the top levels
// of every search hit the same few keys and stay in the 50 MB L2, the
// deep levels go to HBM.
//
// What the design does about that: one thread per query and 256 threads
// per block keep enough independent searches in flight per SM to cover
// the load latency; the two searches share their common prefix (they
// only diverge at the first key equal to q, after which each finishes in
// its own half), so a hit costs about log2 n + log2(run) loads rather
// than 2 log2 n; keys are read through the read-only path (__ldg).
// Keys and queries are int64, the only widths the engine probes with (the
// packed (p, s) / (p, o) key columns and the expansion's cumulative
// degrees).
// Exact at every edge: n == 0, queries below the first or above the last
// key, the int64 max query, and negative keys (UNBOUND rows probe p*R-1).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void sorted_probe_kernel(const int64_t* __restrict__ keys, int n,
                                    const int64_t* __restrict__ queries,
                                    long long q,
                                    int* __restrict__ rank_lo,
                                    int* __restrict__ rank_hi,
                                    uint8_t* __restrict__ contains) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= q) return;
  const int64_t x = queries[i];
  // Joint phase: the answer of both searches lies in [lo, hi].
  int lo = 0, hi = n;
  int ulo = 0, uhi = 0;
  bool split = false;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const int64_t v = __ldg(keys + mid);
    if (v < x) {
      lo = mid + 1;
    } else if (v > x) {
      hi = mid;
    } else {
      // keys[mid] == x: rank_lo lies in [lo, mid], rank_hi in [mid+1, hi]
      ulo = mid + 1;
      uhi = hi;
      hi = mid;
      split = true;
      break;
    }
  }
  if (!split) {
    rank_lo[i] = lo;
    rank_hi[i] = lo;
    contains[i] = 0;
    return;
  }
  while (lo < hi) {  // first index with keys[.] >= x
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + mid) < x) lo = mid + 1; else hi = mid;
  }
  while (ulo < uhi) {  // first index with keys[.] > x
    const int mid = ulo + ((uhi - ulo) >> 1);
    if (__ldg(keys + mid) <= x) ulo = mid + 1; else uhi = mid;
  }
  rank_lo[i] = lo;
  rank_hi[i] = ulo;
  contains[i] = 1;
}

}  // namespace

extern "C" {

// keys: int64 [n], sorted ascending; queries: int64 [q];
// outputs int32 [q], int32 [q], uint8 [q].
// Returns cudaGetLastError() after the launch (0 on success).
int sorted_probe_launch(const void* keys, long long n, const void* queries,
                        long long q, void* rank_lo, void* rank_hi,
                        void* contains, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || q < 0) return (int)cudaErrorInvalidValue;
  if (q == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (q + threads - 1) / threads;
  sorted_probe_kernel<<<(unsigned)blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), (int)n,
      static_cast<const int64_t*>(queries), q, static_cast<int*>(rank_lo),
      static_cast<int*>(rank_hi), static_cast<uint8_t*>(contains));
  return (int)cudaGetLastError();
}

const char* sorted_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

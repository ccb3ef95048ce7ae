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
// the load latency; the two searches share their common prefix
// (bisect::equal_range), so a hit costs about log2 n + log2(run) loads
// rather than 2 log2 n; keys are read through the read-only path.
//
// Two width pairs, each with its callers: int64 keys x int64 queries (the
// packed (p, s) / (p, o) key columns and the expansion's cumulative
// degrees) and int32 keys x int32 queries (the live store's tombstone
// rank searches: int32 base positions against the int32 tombstone
// columns, which are not widened per call).
// Exact at every edge: n == 0, queries below the first or above the last
// key, the dtype's max and min, and negative keys (UNBOUND rows probe
// p*R-1).

#include <cstdint>
#include <cuda_runtime.h>

#include "bisect.cuh"

namespace {

template <typename K>
__global__ void sorted_probe_kernel(const K* __restrict__ keys, int n,
                                    const K* __restrict__ queries,
                                    long long q,
                                    int* __restrict__ rank_lo,
                                    int* __restrict__ rank_hi,
                                    uint8_t* __restrict__ contains) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= q) return;
  int lo, hi;
  bisect::equal_range(keys, n, queries[i], lo, hi);
  rank_lo[i] = lo;
  rank_hi[i] = hi;
  contains[i] = lo < hi ? 1 : 0;
}

template <typename K>
void launch(const void* keys, int n, const void* queries, long long q,
            void* rank_lo, void* rank_hi, void* contains,
            cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (q + threads - 1) / threads;
  sorted_probe_kernel<K><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const K*>(keys), n, static_cast<const K*>(queries), q,
      static_cast<int*>(rank_lo), static_cast<int*>(rank_hi),
      static_cast<uint8_t*>(contains));
}

}  // namespace

extern "C" {

// keys: [n] sorted ascending, queries: [q], both int64 (key_bits 64) or
// both int32 (key_bits 32); outputs int32 [q], int32 [q], uint8 [q].
// Returns cudaGetLastError() after the launch (0 on success).
int sorted_probe_launch(const void* keys, int key_bits, long long n,
                        const void* queries, long long q, void* rank_lo,
                        void* rank_hi, void* contains, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || q < 0) return (int)cudaErrorInvalidValue;
  if (q == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bits == 64)
    launch<int64_t>(keys, (int)n, queries, q, rank_lo, rank_hi, contains, s);
  else if (key_bits == 32)
    launch<int32_t>(keys, (int)n, queries, q, rank_lo, rank_hi, contains, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* sorted_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

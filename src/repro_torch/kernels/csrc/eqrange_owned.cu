// Owner-masked equal-range probe of a subject-hash-sharded store (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/owned_probe.py::
// eqrange_owned_pallas (body _owned_probe_kernel).  For the sorted int64
// key column `keys[0:n)` of one shard, and each query row i (its probe
// key `queries[i]` and the subject id `subjects[i]` the key was built
// from) it writes
//
//     owned[i] = (splitmix64(subjects[i]) & (2^63 - 1)) % n_shards == my_shard
//     lo[i]    = #{k : k <  queries[i]}                (searchsorted "left")
//     hi[i]    = owned[i] ? #{k : k <= queries[i]} : lo[i]
//
// int32, int32 and one byte per row.  A non-owned row gets the empty run
// [lo, lo): its subject lives on another shard, so downstream filters
// and expansions skip it with no mask pass.
//
// What it computes, not how the TPU did it: the Pallas body rebuilds the
// 64-bit hash from 32-bit limbs (the TPU VPU has no 64-bit integer lanes,
// hence its MAX_SHARDS bound on the limb-wise fold of the modulus) and
// streams the whole column past every query tile with a broadcast
// compare.  An H100 thread has native 64-bit integers and a gather, so
// here one thread per row hashes its subject in uint64_t (the constants
// of ref.subject_shard_ref; any n_shards >= 1) and bisects.
//
// What bounds it on this card: a bisection is ceil(log2 n) dependent
// loads (22 for a 2.5M-key shard column), latency- not bandwidth-bound,
// exactly as the sorted probe.  An owned row runs bisect::equal_range
// (the two searches share their prefix); a non-owned row stops after
// the lower bound.  On a store partitioned by this hash a non-owned
// row's key is absent from the shard, so equal_range would stop there
// too: the kernel saves no load against the sorted probe, and costs 8
// bytes of subject per row plus ~10 integer operations of hash.  What
// it buys is the ownership mask in the same pass, for the evaluator's
// account of the rows this shard probed.
//
// Exact at every edge: n == 0, a query equal to the int64 max (the
// comparison is at int64, no padding sentinel), negative and
// int64-extreme subjects (the hash reads their two's-complement bits, as
// the uint64 cast of the reference does), n_shards == 1 (every row
// owned) and n_shards past the reference's 4096.

#include <cstdint>
#include <cuda_runtime.h>

#include "bisect.cuh"

namespace {

__device__ __forceinline__ long long subject_shard(int64_t subject,
                                                   unsigned long long n_shards) {
  uint64_t x = static_cast<uint64_t>(subject);
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  x = x ^ (x >> 31);
  x &= 0x7FFFFFFFFFFFFFFFull;
  return static_cast<long long>(x % n_shards);
}

__global__ void eqrange_owned_kernel(const int64_t* __restrict__ keys, int n,
                                     const int64_t* __restrict__ queries,
                                     const int64_t* __restrict__ subjects,
                                     long long q, long long my_shard,
                                     unsigned long long n_shards,
                                     int* __restrict__ rank_lo,
                                     int* __restrict__ rank_hi,
                                     uint8_t* __restrict__ owned) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= q) return;
  const bool own = subject_shard(subjects[i], n_shards) == my_shard;
  const int64_t x = queries[i];
  int lo, hi;
  if (own) {
    bisect::equal_range(keys, n, x, lo, hi);
  } else {
    lo = bisect::lower_bound(keys, n, x);
    hi = lo;
  }
  rank_lo[i] = lo;
  rank_hi[i] = hi;
  owned[i] = own ? 1 : 0;
}

}  // namespace

extern "C" {

// keys: int64 [n] sorted ascending; queries, subjects: int64 [q];
// outputs int32 [q], int32 [q], uint8 [q].  n_shards >= 1.
// Returns cudaGetLastError() after the launch (0 on success).
int eqrange_owned_launch(const void* keys, long long n, const void* queries,
                         const void* subjects, long long q,
                         long long my_shard, long long n_shards,
                         void* rank_lo, void* rank_hi, void* owned,
                         void* stream) {
  if (n < 0 || n > 0x7fffffffLL || q < 0 || n_shards < 1)
    return (int)cudaErrorInvalidValue;
  if (q == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (q + threads - 1) / threads;
  eqrange_owned_kernel<<<(unsigned)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), (int)n,
      static_cast<const int64_t*>(queries),
      static_cast<const int64_t*>(subjects), q, my_shard,
      static_cast<unsigned long long>(n_shards),
      static_cast<int*>(rank_lo), static_cast<int*>(rank_hi),
      static_cast<uint8_t*>(owned));
  return (int)cudaGetLastError();
}

const char* eqrange_owned_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

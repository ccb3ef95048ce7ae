// The merged base+delta probe's delta half (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/delta_probe.py::
// delta_probe_pallas (body _delta_probe_kernel).  For the sorted int64
// insert keys `ins[0:m)`, the sorted int32 tombstoned base positions
// `tomb[0:t)` and each query i (the probe key of a base eqrange and that
// eqrange's result [base_lo[i], base_hi[i])) it writes
//
//     ins_lo[i]  = #{k in ins  : k <  key[i]}
//     ins_hi[i]  = #{k in ins  : k <= key[i]}
//     tomb_lo[i] = #{p in tomb : p <  base_lo[i]}
//     tomb_hi[i] = #{p in tomb : p <  base_hi[i]}
//
// all int32.  The insert run of the key is ins[ins_lo:ins_hi), and
// tomb_hi - tomb_lo of the base run's rows are dead.
//
// What it computes, not how the TPU did it: the Pallas body streams both
// delta columns past every query tile and counts with a broadcast
// compare, because a TPU lane cannot gather.  Here each thread bisects:
// one equal range in the insert keys (two bisections sharing their
// prefix, bisect::equal_range) and two lower bounds in the tombstone
// positions.
//
// What bounds it on this card: 2 log2 m + 2 log2 t dependent loads per
// query.  The delta columns are small (a 1% write window over the 10M
// store gives m, t ~ 1e5: 1.2 MB of keys and 0.6 MB of positions), so
// after the first queries they sit in the 50 MB L2 and each step is an
// L2 hit; the bytes bound is the query and output streams (32 bytes per
// query).  One thread per query and 256 threads per block keep enough
// independent searches in flight to cover the L2 latency.
//
// Exact at every edge: m == 0 or t == 0 reads nothing and writes 0 to
// that pair; a key equal to the int64 max gets ins_hi == m (the Pallas
// wrapper's clamp); base_lo / base_hi may equal n_base (strict <).

#include <cstdint>
#include <cuda_runtime.h>

#include "bisect.cuh"

namespace {

__global__ void delta_probe_kernel(const int64_t* __restrict__ ins, int m,
                                   const int32_t* __restrict__ tomb, int t,
                                   const int64_t* __restrict__ keys,
                                   const int32_t* __restrict__ base_lo,
                                   const int32_t* __restrict__ base_hi,
                                   long long q,
                                   int* __restrict__ ins_lo,
                                   int* __restrict__ ins_hi,
                                   int* __restrict__ tomb_lo,
                                   int* __restrict__ tomb_hi) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= q) return;
  int a = 0, b = 0;
  if (m > 0) bisect::equal_range(ins, m, keys[i], a, b);
  ins_lo[i] = a;
  ins_hi[i] = b;
  int c = 0, d = 0;
  if (t > 0) {
    c = bisect::lower_bound(tomb, t, base_lo[i]);
    d = bisect::lower_bound(tomb, t, base_hi[i]);
  }
  tomb_lo[i] = c;
  tomb_hi[i] = d;
}

}  // namespace

extern "C" {

// ins: int64 [m] sorted; tomb: int32 [t] sorted; keys: int64 [q];
// base_lo, base_hi: int32 [q]; outputs four int32 [q].
// Returns cudaGetLastError() after the launch (0 on success).
int delta_probe_launch(const void* ins, long long m, const void* tomb,
                       long long t, const void* keys, const void* base_lo,
                       const void* base_hi, long long q, void* ins_lo,
                       void* ins_hi, void* tomb_lo, void* tomb_hi,
                       void* stream) {
  if (m < 0 || m > 0x7fffffffLL || t < 0 || t > 0x7fffffffLL || q < 0)
    return (int)cudaErrorInvalidValue;
  if (q == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (q + threads - 1) / threads;
  delta_probe_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ins), (int)m,
      static_cast<const int32_t*>(tomb), (int)t,
      static_cast<const int64_t*>(keys),
      static_cast<const int32_t*>(base_lo),
      static_cast<const int32_t*>(base_hi), q, static_cast<int*>(ins_lo),
      static_cast<int*>(ins_hi), static_cast<int*>(tomb_lo),
      static_cast<int*>(tomb_hi));
  return (int)cudaGetLastError();
}

const char* delta_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

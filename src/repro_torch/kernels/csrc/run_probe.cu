// Rank and membership of targets within per-row sorted runs (sm_90a).
//
// Replaces the Pallas kernels repro/kernels/run_probe.py::
// run_probe_prefetch_pallas (body _run_probe_prefetch_kernel, the
// default) and run_probe_pallas (body _run_probe_kernel, the dense
// variant); both compute the same function.  For row r with run
// values[lo[r]:hi[r]) sorted ascending and target t[r]:
//
//     pos[r]      = lo[r] + #{k in [lo[r], hi[r]) : values[k] < t[r]}
//     contains[r] = t[r] occurs in values[lo[r]:hi[r])
//
// An empty run (lo >= hi) gives (lo, false).
//
// What it computes, not how the TPU did it: the Pallas bodies stream
// value tiles past every row tile with a window mask (the prefetch
// variant skips tiles outside a row block's window) because a TPU lane
// has no cheap gather.  An H100 thread does, so here each thread bisects
// its own run.
//
// What bounds it on this card: ceil(log2 run) dependent loads per row,
// each a 32-byte sector fetch — latency-bound like the sorted probe, but
// over runs (a subject's objects in PSO order) that are short on the
// WatDiv store, so a row costs a handful of loads, mostly from one or
// two sectors.
//
// What the design does about that: one thread per row keeps many
// independent searches in flight per SM; values are read through the
// read-only path and compared with the target in int64 registers, so
// the int32 o_pso column is probed by int64 targets without the
// promoted int64 copy of the column the TPU wrapper had to build.
// Templated over the value width (int32 and int64); targets are int64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename V>
__global__ void run_probe_kernel(const V* __restrict__ values,
                                 const int* __restrict__ lo,
                                 const int* __restrict__ hi,
                                 const int64_t* __restrict__ targets,
                                 long long r,
                                 int* __restrict__ pos,
                                 uint8_t* __restrict__ contains) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= r) return;
  const int l = lo[i];
  const int h = hi[i];
  const int64_t t = targets[i];
  int a = l, b = h;
  while (a < b) {  // first index in [l, h) with values[.] >= t
    const int mid = a + ((b - a) >> 1);
    if ((int64_t)__ldg(values + mid) < t) a = mid + 1; else b = mid;
  }
  pos[i] = a;
  contains[i] = (a < h && (int64_t)__ldg(values + a) == t) ? 1 : 0;
}

template <typename V>
void launch(const void* values, const void* lo, const void* hi,
            const void* targets, long long r, void* pos, void* contains,
            cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (r + threads - 1) / threads;
  run_probe_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(values), static_cast<const int*>(lo),
      static_cast<const int*>(hi), static_cast<const int64_t*>(targets), r,
      static_cast<int*>(pos), static_cast<uint8_t*>(contains));
}

}  // namespace

extern "C" {

// values: int32 or int64 [n] (value_bits 32 or 64), each run sorted;
// lo, hi: int32 [r] with 0 <= lo, hi <= n where lo < hi;
// targets: int64 [r]; outputs int32 [r], uint8 [r].
// Returns cudaGetLastError() after the launch (0 on success).
int run_probe_launch(const void* values, int value_bits, long long n,
                     const void* lo, const void* hi, const void* targets,
                     long long r, void* pos, void* contains, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || r < 0) return (int)cudaErrorInvalidValue;
  if (r == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_bits == 32)
    launch<int32_t>(values, lo, hi, targets, r, pos, contains, s);
  else if (value_bits == 64)
    launch<int64_t>(values, lo, hi, targets, r, pos, contains, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* run_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

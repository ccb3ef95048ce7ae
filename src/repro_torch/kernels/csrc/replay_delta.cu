// The cache-hit replay: scatter cached fragment deltas onto the lanes'
// seed tables (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/replay.py::replay_delta_pallas
// (body _replay_kernel).  For each lane b of a wave, with the seed table
// seed int32[B, cap, V] (its valid prefix is the unit's input), the
// delta's source rows src int32[B, M] (M <= cap), the values of the
// unit's write columns written int32[B, M, W] and the true output counts
// n_out int32[B], it writes a fresh table
//
//     out[b, j, c] = written[b, j, w(c)]           j < live, c written
//                  = seed[b, clamp(src[b, j], 0, cap - 1), c]
//                                                  j < live, c read
//                  = -1 (UNBOUND)                  otherwise
//     valid[b, j]  = j < n_out[b]
//
// with live = min(n_out[b], M) and w the write-column map (w(c) = -1 for
// a read column).  The clamp is the reference's: its gather clamps an
// out-of-range index.
//
// What it computes, not how the TPU did it: a TPU lane cannot gather, so
// the Pallas body streams seed tiles past every output tile and selects
// with a broadcast compare.  Here it is a plain row gather: one thread
// per output element (b, j, c).  The output is a fresh tensor, because
// an in-place replay races (out[j] reads seed[src[j]], which another
// thread may be writing).
//
// What bounds it on this card: bytes.  Every output element is written
// once (4 B V cap per lane, plus the validity), and each live row reads
// its seed row and its written values once: at B = 8, cap = M = 2^20,
// V = 6, W = 2 about 0.5 GB, 0.15 ms at 3.35 TB/s.  Neighbouring threads
// write neighbouring columns of a row, so stores coalesce; the gathered
// seed rows are as scattered as src makes them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxVars = 64;
constexpr int kThreads = 256;

// The write-column map, passed by value (no device allocation).
struct ColMap {
  int w[kMaxVars];
};

__global__ void replay_delta_kernel(const int32_t* __restrict__ seed,
                                   const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ written,
                                   const int32_t* __restrict__ n_out,
                                   long long cap, int n_vars, long long m,
                                   int n_w, ColMap map, long long total,
                                   int32_t* __restrict__ out,
                                   bool* __restrict__ valid) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int c = (int)(e % n_vars);
  const long long r = e / n_vars;  // b * cap + j
  const long long b = r / cap, j = r % cap;
  const long long n = n_out[b];
  const long long live = n < m ? n : m;
  int32_t v = -1;
  if (j < live) {
    const int w = map.w[c];
    if (w >= 0) {
      v = written[(b * m + j) * n_w + w];
    } else {
      long long s = src[b * m + j];
      s = s < 0 ? 0 : (s > cap - 1 ? cap - 1 : s);
      v = seed[(b * cap + s) * n_vars + c];
    }
  }
  out[e] = v;
  if (c == 0) valid[r] = j < n;
}

}  // namespace

extern "C" {

// seed: int32 [lanes, cap, n_vars]; src: int32 [lanes, m]; written: int32
// [lanes, m, n_w]; n_out: int32 [lanes]; wmap: a HOST array of n_vars
// ints (the write slot of each column, -1 for a read column), copied
// into the launch's arguments; out: int32 [lanes, cap, n_vars], valid:
// bool [lanes, cap], both fresh.  Returns cudaGetLastError() after the
// launch (0 on success).
int replay_delta_launch(const void* seed, const void* src,
                        const void* written, const void* n_out,
                        long long lanes, long long cap, long long n_vars,
                        long long m, long long n_w, const int* wmap,
                        void* out, void* valid, void* stream) {
  if (lanes < 0 || cap < 0 || n_vars < 1 || n_vars > kMaxVars || m < 0 ||
      m > cap || n_w < 0 || n_w > n_vars)
    return (int)cudaErrorInvalidValue;
  ColMap map;
  for (int c = 0; c < kMaxVars; ++c) map.w[c] = c < n_vars ? wmap[c] : -1;
  const long long total = lanes * cap * n_vars;
  if (total == 0) return (int)cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  replay_delta_kernel<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seed), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(written),
      static_cast<const int32_t*>(n_out), cap, (int)n_vars, m, (int)n_w, map,
      total, static_cast<int32_t*>(out), static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}

const char* replay_delta_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

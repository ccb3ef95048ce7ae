// The wave fingerprint: an order-sensitive 4 x uint32 digest of the valid
// rows of each lane's binding-table block (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/fingerprint.py::
// fingerprint_rows_pallas (body _fp_kernel).  For each lane b of a block
// int32[B, n, C] with validity bool[B, n] it computes, in wrapping uint32
// arithmetic,
//
//     h_i   = fold over columns c of mix32(h ^ (v[i, c] + (c+1)*COL))
//     g_i   = mix32(h_i ^ mix32((i+1) * POS))      i = row within the lane
//     acc_s = sum over valid i of mix32(g_i + SALT_s)          s = 0..3
//     out_s = mix32(acc_s ^ (n_valid * POS + SALT_s))
//
// the hash the JAX reference keys its fragment cache with (constants in
// repro_torch/kernels/ref.py).
//
// What it computes, not how the TPU did it: the Pallas body streams row
// tiles through one core and carries the four sums from grid step to
// grid step.  Here blocks run in parallel in no order, so the sums are
// reduced across blocks with atomics.  fingerprint_rows_kernel has one
// thread per row of one lane (grid (ceil(n / 256), B)); each warp
// reduces its rows' four salted terms and its valid count with shuffles,
// and lane 0 of the warp adds them into the zeroed accumulator acc[B][5]
// with one atomicAdd each.  Wrapping uint32 addition is associative and
// commutative, so the digest is bit-exact whatever order the atomics
// land in.  fingerprint_rows_finalize_kernel then applies the n-mix, one
// thread per lane and salt; it runs for n == 0 too (the empty digest is
// mix32(0 ^ SALT_s)), where the row kernel is not launched.
//
// What bounds it on this card: bytes.  Every row's validity byte is
// read once, and its 4 C bytes of values only where the row is valid: at
// B = 8, n = 2^20, C = 3 at most 109 MB (every row valid), 0.033 ms at
// 3.35 TB/s; the hash is some 10 C + 58 integer operations per valid
// row.  The C columns of a row are read by one thread
// (strided by C), which the L1 and L2 coalesce across the warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kSeed = 0x9E3779B9u;
constexpr unsigned kCol = 0x85EBCA6Bu;
constexpr unsigned kPos = 0x9E3779B1u;
__constant__ unsigned kSalts[4] = {0x243F6A88u, 0x85A308D3u, 0x13198A2Eu,
                                   0x03707344u};
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned mix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void fingerprint_rows_kernel(const int32_t* __restrict__ block,
                                        const bool* __restrict__ valid,
                                        long long n, int n_cols,
                                        unsigned* __restrict__ acc) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  unsigned t[5] = {0u, 0u, 0u, 0u, 0u};
  if (i < n && valid[b * n + i]) {
    const int32_t* row = block + (b * n + i) * (long long)n_cols;
    unsigned h = kSeed;
    for (int c = 0; c < n_cols; ++c)
      h = mix32(h ^ ((unsigned)row[c] + (unsigned)(c + 1) * kCol));
    const unsigned g = mix32(h ^ mix32((unsigned)(i + 1) * kPos));
    for (int s = 0; s < 4; ++s) t[s] = mix32(g + kSalts[s]);
    t[4] = 1u;
  }
  for (int off = 16; off > 0; off >>= 1)
    for (int s = 0; s < 5; ++s)
      t[s] += __shfl_down_sync(0xffffffffu, t[s], off);
  if ((threadIdx.x & 31) == 0)
    for (int s = 0; s < 5; ++s)
      if (t[s]) atomicAdd(acc + b * 5 + s, t[s]);
}

__global__ void fingerprint_rows_finalize_kernel(
    const unsigned* __restrict__ acc, int lanes, unsigned* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= lanes * 4) return;
  const int b = k / 4, s = k % 4;
  out[k] = mix32(acc[b * 5 + s] ^ (acc[b * 5 + 4] * kPos + kSalts[s]));
}

}  // namespace

extern "C" {

// block: int32 [lanes, n, n_cols]; valid: bool [lanes, n]; acc: uint32
// [lanes, 5], zeroed by the caller; out: uint32 [lanes, 4] (the digests'
// bit patterns).  Launches the row kernel (when n > 0) and the finalize
// on `stream`.  Returns cudaGetLastError() after the launches.
int fingerprint_rows_launch(const void* block, const void* valid,
                            long long lanes, long long n, long long n_cols,
                            void* acc, void* out, void* stream) {
  if (lanes < 0 || lanes > 65535 || n < 0 || n_cols < 0 ||
      n_cols > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (lanes == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const dim3 grid((unsigned)((n + kThreads - 1) / kThreads),
                    (unsigned)lanes);
    fingerprint_rows_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const int32_t*>(block), static_cast<const bool*>(valid),
        n, (int)n_cols, static_cast<unsigned*>(acc));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int k = (int)lanes * 4;
  fingerprint_rows_finalize_kernel<<<(k + 127) / 128, 128, 0, st>>>(
      static_cast<const unsigned*>(acc), (int)lanes,
      static_cast<unsigned*>(out));
  return (int)cudaGetLastError();
}

const char* fingerprint_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Attention forward with an online softmax, GQA and an optional causal
// mask (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body _flash_kernel).  For q [B, Hq, Sq, D] and
// k, v [B, Hkv, Sk, D] (Hq % Hkv == 0, query head h reads KV head
// h / (Hq / Hkv)) it computes, for every (b, h, query row i),
//
//     o[i] = sum_j softmax_j(q[i] . k[j] * scale) v[j]
//
// over the keys j < Sk, and with `causal` only j <= i (top-left aligned,
// also when Sq != Sk).  Masked scores are -1e30, as in the reference, the
// running max, denominator and accumulator are f32, the denominator is
// clamped at 1e-30, and the result is rounded once to the input type
// (bf16 round-to-nearest-even, or f32).
//
// What it computes, not how the TPU did it: the Pallas kernel walks the
// KV blocks of one (head, query block) as a sequential grid axis and
// carries m, l and the accumulator in VMEM scratch.  Here one CTA of 256
// threads owns one (batch x query head, block of 64 query rows) and runs
// the whole KV loop itself, so nothing is carried between CTAs.  Per KV
// tile of 64 keys:
//
//   1. the K tile is staged in shared memory as f32 (zero beyond Sk and
//      beyond D);
//   2. S = Q K^T on CUDA cores: thread (tx, ty) of a 16 x 16 grid owns
//      the 4 x 4 scores of rows ty + 16 i and keys tx + 16 j;
//   3. the online softmax in registers: row max and row sum over the 16
//      threads of a row with xor shuffles, the accumulator rescaled by
//      exp(m_old - m_new), P written to shared memory;
//   4. the V tile replaces the K tile, and O += P V: the same thread owns
//      rows ty + 16 i and columns tx + 16 c of the f32 accumulator.
//
// KV tiles wholly above the diagonal are skipped, as _flash_kernel skips
// them; their terms would be exp(-1e30 - m) = 0.  Query CTAs are
// scheduled last-block-first, so the causal mask's longest rows start first.
// Offsets are 64-bit, and every tensor is addressed through the element
// strides it comes with: the layers hand over transposed views
// ([B, S, H, D] -> [B, H, S, D]).  Loads are scalar, so any D <= 256 works,
// aligned or not (D = 14 rows are 28 bytes); the tiles are sized by D
// rounded up to a multiple of 16, in dynamic shared memory (152 KB at
// D = 256, opted in with cudaFuncSetAttribute).
//
// What bounds it on this card: operations.  4 B Hq Sq Sk D flops (half
// that with the causal mask) against bytes of q, k, v and o read or
// written once: at the qwen2-7b prefill shape (Hq 28, Hkv 4, S 4096,
// D 128) 1.2e11 flops, 0.122 ms at the 989 TFLOP/s bf16 tensor-core
// peak, against 67 MB, 0.020 ms at 3.35 TB/s.  This kernel does its
// products as f32 FMAs on CUDA cores (67 TFLOP/s peak), and its two inner
// loops make one shared-memory load per one to two FMAs, so it is bound
// by shared-memory bandwidth well below even that peak.  wgmma tiles fed
// by TMA are the way to the bound, in a later kernel.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // a 16 x 16 grid of (tx, ty)
constexpr int kPS = kBK + 16;  // row stride of the P tile, in floats
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {
  long long b, h, s, d;
};

// Floats of dynamic shared memory for head dims up to 16 * DC.
template <int DC>
constexpr int smem_floats() {
  return (kBQ + kBK) * (16 * DC + 1) + kBQ * kPS;
}

// Stage rows [r0, r0 + rows) of one head's [S, D] slice as f32, zero
// outside [0, n) x [0, d); tile row stride SD.
template <typename T, int DT, int SD, int ROWS>
__device__ __forceinline__ void stage(float* tile, const T* src, Strides st,
                                      long long r0, long long n, int d) {
  for (int idx = threadIdx.x; idx < ROWS * DT; idx += kThreads) {
    const int r = idx / DT, c = idx % DT;
    const long long row = r0 + r;
    tile[r * SD + c] =
        (row < n && c < d) ? load_f32(src + row * st.s + c * st.d) : 0.f;
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int hq, int group, long long sq, long long sk,
                           int d, Strides qs, Strides ks, Strides vs,
                           float scale, int causal) {
  constexpr int DT = 16 * DC;  // D rounded up to a multiple of 16
  constexpr int SD = DT + 1;   // odd stride: the 16 key rows hit 16 banks
  extern __shared__ float smem[];
  float* qt = smem;            // [kBQ][SD]
  float* kv = qt + kBQ * SD;   // [kBK][SD]: the K tile, then the V tile
  float* pt = kv + kBK * SD;   // [kBQ][kPS]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long bh = blockIdx.x;
  const long long b = bh / hq;
  const int h = (int)(bh % hq);
  const int hk = h / group;
  const long long q0 = (long long)(gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + bh * sq * d;  // o is contiguous [B, Hq, Sq, D]

  stage<T, DT, SD, kBQ>(qt, qb, qs, q0, sq, d);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // keys past the block's last row are masked for every row: skip them
  const long long kv_end = causal ? (sk < q0 + kBQ ? sk : q0 + kBQ) : sk;
  const long long n_tiles = (kv_end + kBK - 1) / kBK;
  for (long long t = 0; t < n_tiles; ++t) {
    const long long k0 = t * kBK;
    __syncthreads();  // the last tile's V and P reads are done
    stage<T, DT, SD, kBK>(kv, kb, ks, k0, sk, d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DT; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qt[(ty + 16 * i) * SD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kv[(tx + 16 * j) * SD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kj = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kj >= sk || (causal && kj > qi)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        rs += p;
        pt[(ty + 16 * i) * kPS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // K reads done, P written
    stage<T, DT, SD, kBK>(kv, vb, vs, k0, sk, d);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = pt[(ty + 16 * i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = kv[kk * SD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store_out(ob + row * d + col, acc[i][c] * inv);
    }
  }
}

template <typename T, int DC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   long long b, int hq, int group, long long sq,
                   long long sk, int d, const Strides* st, float scale,
                   int causal, cudaStream_t stream) {
  const int bytes = smem_floats<DC>() * (int)sizeof(float);
  auto kernel = flash_attention_kernel<T, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(b * hq), (unsigned)((sq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, group, sq, sk, d,
      st[0], st[1], st[2], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     long long b, int hq, int group, long long sq,
                     long long sk, int d, const Strides* st, float scale,
                     int causal, cudaStream_t stream) {
  if (d <= 16)
    return launch<T, 1>(q, k, v, o, b, hq, group, sq, sk, d, st, scale,
                        causal, stream);
  if (d <= 32)
    return launch<T, 2>(q, k, v, o, b, hq, group, sq, sk, d, st, scale,
                        causal, stream);
  if (d <= 64)
    return launch<T, 4>(q, k, v, o, b, hq, group, sq, sk, d, st, scale,
                        causal, stream);
  if (d <= 128)
    return launch<T, 8>(q, k, v, o, b, hq, group, sq, sk, d, st, scale,
                        causal, stream);
  return launch<T, 16>(q, k, v, o, b, hq, group, sq, sk, d, st, scale,
                       causal, stream);
}

}  // namespace

extern "C" {

// q: [b, hq, sq, d], k and v: [b, hkv, sk, d], f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1), addressed by the element strides in `strides` (host
// memory: b, h, s, d strides of q, then of k, then of v); o: contiguous
// [b, hq, sq, d] of the same type.  Launches on `stream` and returns
// cudaGetLastError() after the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, long long b, long long hq, long long hkv,
                           long long sq, long long sk, long long d,
                           const long long* strides, float scale,
                           int causal, int is_bf16, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1 ||
      d < 1 || d > 256 || b * hq > 0x7fffffffLL ||
      (sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides st[3] = {{strides[0], strides[1], strides[2], strides[3]},
                         {strides[4], strides[5], strides[6], strides[7]},
                         {strides[8], strides[9], strides[10], strides[11]}};
  const int group = (int)(hq / hkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, b, (int)hq, group, sq,
                                        sk, (int)d, st, scale, causal, s)
              : launch_d<float>(q, k, v, o, b, (int)hq, group, sq, sk,
                                (int)d, st, scale, causal, s);
  return (int)err;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

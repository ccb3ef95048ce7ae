// Attention forward for Hopper tensor cores: wgmma on bf16 tiles that TMA
// brings into shared memory, an online softmax in registers, GQA and an
// optional causal mask (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body _flash_kernel) for the operands the
// wrapper's `wgmma_eligible` admits: bfloat16 q [B, Hq, Sq, D] and k, v
// [B, Hkv, Sk, D] with D in {64, 128, 256}, a unit stride on D, 16-byte
// aligned bases and every other stride a multiple of 8 elements (TMA's
// rules).  It computes what csrc/flash_attention.cu computes, for the same
// inputs: query head h reads KV head h / (Hq / Hkv); with `causal` key j
// is seen by query row i only if j <= i (top-left aligned, also when
// Sq != Sk); masked scores are -1e30; the running max, denominator and
// accumulator are f32; the denominator is clamped at 1e-30; the result is
// rounded to bf16 once into a contiguous [B, Hq, Sq, D].
//
// Shape.  One CTA of 384 threads per (batch x query head, block of 128
// query rows), query blocks scheduled last-first so the causal mask's
// longest rows start first.  Warpgroups 0 and 1 are consumers, each owning
// 64 query rows; warpgroup 2 is the producer, and one of its threads
// issues every TMA load.  setmaxnreg moves registers from the producer
// (24) to the consumers (240): at D = 256 the O accumulator alone is 128
// f32 registers a thread.
//
// Loads.  Each operand has a 4-d tensor map (D, S, H, B) built on the host
// from the strides it comes with, so the layers' transposed views of
// [B, S, H, D] load as they are.  A box is 64 rows x 64 bf16 (128 bytes a
// row) with the 128-byte swizzle, so a row of D values is D / 64 boxes.
// Q is loaded once; K and V tiles of 64 keys come through a ring of two
// stages, each with full barriers for K and for V (the producer arms them
// with the tile's bytes) and an empty barrier on which all 256 consumer
// threads arrive when their products have read the stage.  TMA fills rows
// past Sq and Sk with zeros; the masking below sets those keys' scores to
// -1e30, so a zero is never taken for a score.
//
// Products.  S = Q K^T is wgmma m64n64k16 with both operands in shared
// memory, K-major, one instruction per 16 columns of D (the descriptor's
// start moves 32 bytes inside a swizzled 128-byte row, then to the next
// box).  O += P V reads V as the MN-major B operand (the transpose bit),
// 64 columns of D per instruction, 16 keys per k step (2048 bytes).  P is
// fed from registers: the f32 accumulator fragment, converted pairwise, is
// the A-fragment layout.  A single bf16 P would put the prefill's outputs
// (|o| a few hundredths at S = 4096) up to 60x outside the repository's
// elementwise bf16 bound, so P is split, hi = bf16(p) and
// lo = bf16(p - hi), and both are multiplied into the same f32
// accumulator: P V in f32 as the reference computes it, within ~2^-16 of
// p, at twice the tensor work of the P V half.
//
// Softmax.  On the S accumulator fragment: thread `lane` of warp w holds
// rows 16 w + lane / 4 and that + 8, columns 8 j + 2 (lane % 4) + {0, 1};
// a row's max and sum reduce over the quad of threads that holds it.
// Scores are scaled by scale * log2(e) and exponentiated with exp2.  KV
// tiles wholly above a warpgroup's diagonal are skipped (their terms would
// be exp(-1e30 - m) = 0), diagonal and ragged tiles are masked.
//
// What bounds it on this card: operations.  4 B Hq Sq Sk D flops (half
// that with the causal mask) at the 989 TFLOP/s bf16 tensor peak: at the
// qwen2-7b prefill shape (Hq 28, Hkv 4, S 4096, D 128) 1.2e11 flops,
// 0.122 ms, against 67 MB of q, k, v and o, 0.020 ms at 3.35 TB/s.  The
// split P makes the tensor work 1.5x that.  Each warpgroup waits for its
// own products before its softmax; the two consumers overlap each other's
// softmax and products only as the warp schedulers interleave them.

#include <cstdint>
#include <cstdio>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached
                   // through cudaGetDriverEntryPointByVersion, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 128;       // query rows per CTA, 64 per consumer
constexpr int kBK = 64;        // keys per K / V tile
constexpr int kBox = 64;       // a TMA box is kBox rows x kBox bf16
constexpr int kBoxBytes = kBox * kBox * 2;
constexpr int kStages = 2;     // K / V ring depth
constexpr int kThreads = 384;  // consumers: warpgroups 0, 1; producer: 2
constexpr int kConsumers = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeError = 10000;  // + CUresult of a failed tensor map

// Dynamic shared memory: Q [2 warpgroups][D / 64 boxes], then the K ring,
// the V ring ([stage][D / 64 boxes] each) and the barriers, with room to
// align the base to the 1024 bytes a 128-byte swizzle repeats over.
template <int D>
constexpr int smem_bytes() {
  return (2 + 2 * kStages) * (D / 64) * kBoxBytes + 1024 + 64;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// A wgmma shared-memory matrix descriptor for the 128-byte swizzle:
// start address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads of an accumulator across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B, m64n64k16, bf16 in, f32 accumulate; A and B from shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16, bf16 in, f32 accumulate; A from registers (the
// accumulator-shaped fragment), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 __nv_bfloat16* __restrict__ o, int hq,
                                 int group, int sq, int sk, float scale_log2,
                                 int causal) {
  constexpr int kC = D / 64;  // boxes per row of D values
  constexpr int kTile = kC * kBoxBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                    // [2][kC] boxes
  const uint32_t k_s = q_s + 2 * kTile;         // [kStages][kC] boxes
  const uint32_t v_s = k_s + kStages * kTile;   // [kStages][kC] boxes
  const uint32_t bars = v_s + kStages * kTile;  // q, k[], v[], empty[]
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };

  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh % hq, hk = h / group;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kBQ;
  // keys past the block's last row are masked for every row: skip them
  const int kv_end = causal ? min(sk, q0 + kBQ) : sk;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_full, 2 * kTile);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < kC; ++c)
          tma_load(q_s + (w * kC + c) * kBoxBytes, &qmap, q_full, c * kBox,
                   q0 + w * 64, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t phase = (t / kStages) & 1;
        mbar_wait(empty(s), phase ^ 1);  // the first round passes at once
        mbar_expect_tx(k_full(s), kTile);
        for (int c = 0; c < kC; ++c)
          tma_load(k_s + s * kTile + c * kBoxBytes, &kmap, k_full(s),
                   c * kBox, t * kBK, hk, b);
        mbar_expect_tx(v_full(s), kTile);
        for (int c = 0; c < kC; ++c)
          tma_load(v_s + s * kTile + c * kBoxBytes, &vmap, v_full(s),
                   c * kBox, t * kBK, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row0 = q0 + 64 * wg;               // the warpgroup's first row
    const int row_a = row0 + 16 * warp + lane / 4;  // and row_a + 8
    const int col_t = 2 * (lane % 4);           // + 8 j + {0, 1}
    const uint32_t q_wg = q_s + wg * kTile;

    float acc[kC][32];
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t phase = (t / kStages) & 1;
      const int k0 = t * kBK;
      const uint32_t k_t = k_s + s * kTile, v_t = v_s + s * kTile;
      mbar_wait(k_full(s), phase);
      if (!causal || k0 <= row0 + 63) {  // some key visible to some row
        // S = Q K^T: D / 16 k steps of 16 columns
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
          wgmma_ss(sc, desc(q_wg + off, 16, 1024), desc(k_t + off, 16, 1024),
                   kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scale, mask, and the online softmax on the fragment
        const bool masked = k0 + kBK > sk || (causal && k0 + kBK - 1 > row0);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          float x = sc[i] * scale_log2;
          if (masked) {
            const int col = k0 + 8 * (i >> 2) + col_t + (i & 1);
            if (col >= sk || (causal && col > row_a + 8 * r)) x = kNegInf;
          }
          sc[i] = x;
          mx[r] = fmaxf(mx[r], x);
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = exp2f(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= alpha[r];  // this thread's share; the quad sums at the end
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const float p = exp2f(sc[i] - m[r]);
          sc[i] = p;
          l[r] += p;
        }
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];

        // P as A fragments, hi + lo: k step kk holds S's columns
        // 16 kk .. 16 kk + 15, registers 8 kk .. 8 kk + 7 in pairs
        uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float x0 = sc[8 * kk + 2 * j], x1 = sc[8 * kk + 2 * j + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
            const float2 hf = __bfloat1622float2(hi);
            p_hi[kk][j] = bf16x2_bits(hi);
            p_lo[kk][j] =
                bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
          }

        // O += P V: V's 16-key k steps are 2048 bytes apart, its 64-column
        // slices one box apart
        mbar_wait(v_full(s), phase);
#pragma unroll
        for (int c = 0; c < kC; ++c) fence_regs(acc[c]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const uint64_t dv =
                desc(v_t + c * kBoxBytes + kk * 2048, kBoxBytes, 1024);
            wgmma_rs(acc[c], p_hi[kk], dv);
            wgmma_rs(acc[c], p_lo[kk], dv);
          }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < kC; ++c) fence_regs(acc[c]);
      } else {
        mbar_wait(v_full(s), phase);
      }
      mbar_arrive(empty(s));  // this thread's reads of the stage are done
    }

    // o = acc / l, rounded to bf16 once; o is contiguous [B, Hq, Sq, D]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      const int row = row_a + 8 * r;
      if (row < sq) {
        __nv_bfloat16* out = o + ((long long)bh * sq + row) * D + col_t;
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(out + 64 * c + 8 * j) =
                __floats2bfloat162_rn(acc[c][4 * j + 2 * r] * inv,
                                      acc[c][4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of one [B, H, S, D] operand with element strides st
// (b, h, s, d): dims (D, S, H, B), boxes of 64 x 64, 128-byte swizzle,
// zeros outside.  A dimension of extent 1 is never stepped over, so its
// stride is replaced by the row's bytes (TMA wants multiples of 16).
CUresult encode(CUtensorMap* map, const void* ptr, long long b, long long h,
                long long s, long long d, const long long* st) {
  const long long ext[3] = {s, h, b};
  const long long str[3] = {st[2], st[1], st[0]};
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                        (cuuint64_t)b};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = (cuuint64_t)(ext[i] > 1 ? str[i] : d) * 2;
  const cuuint32_t box[4] = {kBox, kBox, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  EncodeTiled fn = encoder();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// TMA's rules, as the wrapper's wgmma_eligible states them.
bool tma_ok(const void* ptr, long long b, long long h, long long s,
            const long long* st) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || st[3] != 1) return false;
  const long long ext[3] = {b, h, s};
  for (int i = 0; i < 3; ++i)
    if (ext[i] > 1 && (st[i] <= 0 || st[i] % 8 != 0)) return false;
  return true;
}

template <int D>
cudaError_t launch(const CUtensorMap* maps, void* o, long long b, int hq,
                   int group, int sq, int sk, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  auto kernel = flash_attention_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(b * hq), (unsigned)((sq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), hq, group,
      sq, sk, scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: [b, hq, sq, d], k and v: [b, hkv, sk, d], bf16, addressed by the
// element strides in `strides` (host memory: b, h, s, d strides of q, then
// of k, then of v); d in {64, 128, 256}; TMA's rules on strides and bases
// (tma_ok).  o: contiguous bf16 [b, hq, sq, d].  Launches on `stream` and
// returns cudaGetLastError() after the launch, cudaErrorInvalidValue for
// operands outside the rules, or kEncodeError + the CUresult of a tensor
// map the driver refused.
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 void* o, long long b, long long hq,
                                 long long hkv, long long sq, long long sk,
                                 long long d, const long long* strides,
                                 float scale, int causal, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1 ||
      (d != 64 && d != 128 && d != 256) || b * hq > 0x7fffffffLL ||
      sq > 0x7fffffffLL - kBQ || sk > 0x7fffffffLL ||
      (sq + kBQ - 1) / kBQ > 65535 || !tma_ok(q, b, hq, sq, strides) ||
      !tma_ok(k, b, hkv, sk, strides + 4) ||
      !tma_ok(v, b, hkv, sk, strides + 8))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const long long heads[3] = {hq, hkv, hkv}, rows[3] = {sq, sk, sk};
  for (int i = 0; i < 3; ++i) {
    const CUresult res =
        encode(&maps[i], ptrs[i], b, heads[i], rows[i], d, strides + 4 * i);
    if (res != CUDA_SUCCESS) return kEncodeError + (int)res;
  }
  const int group = (int)(hq / hkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d == 64)
    err = launch<64>(maps, o, b, (int)hq, group, (int)sq, (int)sk, scale,
                     causal, s);
  else if (d == 128)
    err = launch<128>(maps, o, b, (int)hq, group, (int)sq, (int)sk, scale,
                      causal, s);
  else
    err = launch<256>(maps, o, b, (int)hq, group, (int)sq, (int)sk, scale,
                      causal, s);
  return (int)err;
}

const char* flash_attention_wgmma_error_string(int code) {
  static thread_local char buf[96];
  if (code >= kEncodeError) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled returned CUresult %d",
             code - kEncodeError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Pieces shared by the net-mode stage-ensemble kernels (plain_body.cuh,
// dense_body.cuh): the block shape, bf16 fragment helpers, the
// shared-memory staging copy, the tap sources, the bf16 broadcast head and
// K3's stage-mix epilogue (the JAX package's _apply_stage_mix_t, and its
// site-major twin _apply_stage_mix), which every kernel with a mix
// epilogue takes over as it is.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSites = 16 * kWarps;   // sites per block, 16 per warp
constexpr int kMaxModes = 6;
constexpr int kHeadRows = 64;         // 4 rotations x 16 output lanes

// Stage-mix epilogues, in the order of unit_kernel.MIXES.
enum Mix { kNone = 0, kInner = 1, kFinal = 2, kFinalU8 = 3, kFinalPack = 4 };
// Where a pass's 4 taps come from: kSite, the (n, 16M) tap matrix; kFeature,
// the (16M, n) one; kPlane, the flat edge-padded plane; kUnit, (n, 4).
enum Src { kSite = 0, kFeature = 1, kPlane = 2, kUnit = 3 };

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld_b32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows x cols bf16 from global (row stride cols) to shared (row stride
// ld), in 16-byte chunks.  cols % 8 == 0; both sides 16-byte aligned.
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src, int rows,
                                          int cols) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    *reinterpret_cast<int4*>(dst + r * ld + 8 * c) =
        __ldg(reinterpret_cast<const int4*>(src + (long long)r * cols + 8 * c));
  }
}

// Tap q of the flat edge-padded plane; outside [0, n) it reads 0, as the
// TPU's zero-padded windows do.
__device__ __forceinline__ float tap(const __nv_bfloat16* plane, long long n,
                                     long long q) {
  return (q >= 0 && q < n) ? __bfloat162float(plane[q]) : 0.f;
}

// 4 contiguous bf16 taps of row s (row stride `stride`), 0 past n.
__device__ __forceinline__ void load_taps(const __nv_bfloat16* taps,
                                          long long s, long long n, int stride,
                                          int col, float (&t)[4]) {
  if (s < n) {
    const uint2 raw =
        *reinterpret_cast<const uint2*>(taps + s * stride + col);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    t[0] = __low2float(lo);
    t[1] = __high2float(lo);
    t[2] = __low2float(hi);
    t[3] = __high2float(hi);
  } else {
    t[0] = t[1] = t[2] = t[3] = 0.f;
  }
}

// The 4 taps of site s in rows col .. col+3 of a feature-major (16M, n)
// matrix, 0 past n.
__device__ __forceinline__ void load_taps_t(const __nv_bfloat16* taps,
                                            long long s, long long n, int col,
                                            float (&t)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    t[k] = s < n ? __bfloat162float(taps[(col + k) * n + s]) : 0.f;
}

// The TPU kernels' broadcast head of one feature: every product and every
// running sum rounded to bf16, in tap order, then + b in bf16, then ReLU,
// so it is bit-identical to the JAX kernels (XLA rounds each bf16 op).
// w[k * ks] is tap k's weight and b the bias (float copies of bf16
// values).  The explicit __fmul_rn / __fadd_rn keep the compiler from
// fusing them into an FMA.
__device__ __forceinline__ float chain_head(const float* w, int ks, float b,
                                            const float (&t)[4]) {
  float s = bf(__fmul_rn(t[0], w[0]));
#pragma unroll
  for (int k = 1; k < 4; ++k)
    s = bf(__fadd_rn(s, bf(__fmul_rn(t[k], w[k * ks]))));
  return fmaxf(bf(__fadd_rn(s, b)), 0.f);
}

__device__ __forceinline__ float final_value(float acc, int modes) {
  return fminf(fmaxf(rintf(__fdiv_rn(acc, (float)modes)), 0.f), 255.f);
}

// The stage mix of a warp's accumulators: acc[nt][i] is site (i < 2 ?
// s_lo : s_hi), lane nt*8 + 2t + (i & 1).  Feature-major, out is (16, n)
// float32 for kNone (raw acc) and kFinal (round(acc/M)); (16, n) bf16 for
// kFinalU8 (its clip to [0, 255]); (1, n) bf16 for kInner (XLA's
// fma(acc, 1/(4M), 127), rounded and clipped, times 1/255); (4, n) uint32
// for kFinalPack (byte sx of word sy = lane 4*sy + sx).  Site-major (SITE),
// the same values as (n, 16) and, for kInner, (n, 1); there is no packed
// site-major form.
template <int MIX, bool SITE = false>
__device__ __forceinline__ void store_mix(const float (&acc)[2][4], void* out_,
                                          long long n, long long s_lo,
                                          long long s_hi, int t, int modes,
                                          float inv_4m) {
  static_assert(!(SITE && MIX == kFinalPack), "no packed site-major form");
  if (SITE && MIX != kInner) {
    // this thread's lanes nt*8 + 2t and + 1 of a site are adjacent
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long s = h ? s_hi : s_lo;
      if (s >= n) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float a0 = acc[nt][2 * h], a1 = acc[nt][2 * h + 1];
        const long long i = s * 16 + nt * 8 + 2 * t;
        if (MIX == kNone) {
          *reinterpret_cast<float2*>(static_cast<float*>(out_) + i) =
              make_float2(a0, a1);
        } else if (MIX == kFinal) {
          *reinterpret_cast<float2*>(static_cast<float*>(out_) + i) =
              make_float2(rintf(__fdiv_rn(a0, (float)modes)),
                          rintf(__fdiv_rn(a1, (float)modes)));
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(out_) + i) =
              __floats2bfloat162_rn(final_value(a0, modes),
                                    final_value(a1, modes));
        }
      }
    }
    return;
  }
  if (MIX == kFinalPack) {
    // lane 4*sy + sx: this thread holds sx = 2(t&1), 2(t&1)+1 of
    // sy = 2nt + (t>>1); the partner thread t^1 holds the other two bytes
    uint32_t* out = static_cast<uint32_t*>(out_);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t q0 = (uint32_t)final_value(acc[nt][2 * h], modes);
        const uint32_t q1 = (uint32_t)final_value(acc[nt][2 * h + 1], modes);
        const uint32_t part = (q0 | (q1 << 8)) << (16 * (t & 1));
        const uint32_t word = part | __shfl_xor_sync(0xffffffffu, part, 1);
        const long long s = h ? s_hi : s_lo;
        const int sy = 2 * nt + (t >> 1);
        if ((t & 1) == 0 && s < n) out[sy * n + s] = word;
      }
    }
    return;
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long s = i < 2 ? s_lo : s_hi;
      const int l = nt * 8 + 2 * t + (i & 1);
      if (s >= n) continue;
      const float a = acc[nt][i];
      if (MIX == kNone) {
        static_cast<float*>(out_)[l * n + s] = a;
      } else if (MIX == kFinal) {
        static_cast<float*>(out_)[l * n + s] = rintf(__fdiv_rn(a, (float)modes));
      } else if (MIX == kFinalU8) {
        static_cast<__nv_bfloat16*>(out_)[l * n + s] =
            __float2bfloat16_rn(final_value(a, modes));
      } else if (l == 0) {  // kInner: XLA's fma(acc, 1/(4M), 127)
        const float m = fminf(fmaxf(rintf(__fmaf_rn(a, inv_4m, 127.f)), 0.f),
                              255.f);
        static_cast<__nv_bfloat16*>(out_)[s] =
            __float2bfloat16_rn(__fmul_rn(m, 1.f / 255.f));
      }
    }
  }
}

}  // namespace

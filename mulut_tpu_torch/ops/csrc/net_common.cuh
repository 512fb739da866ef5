// Pieces shared by the net-mode stage-ensemble kernels (plain_body.cuh,
// dense_body.cuh), both wgmma bodies over 64-site warpgroup tiles: the
// weights' staging into wgmma's swizzled layout, the tap sources, the bf16
// broadcast head in packed bf16x2 arithmetic, the packing of a layer's
// accumulator into the next layer's A fragments, the output head with its
// round(127 tanh) accumulation, the block's mode and tile loop with the
// raw accumulator's carry across modes, K3's stage-mix epilogue (the JAX
// package's _apply_stage_mix_t, and its site-major twin _apply_stage_mix),
// which every kernel with a mix epilogue takes over as it is, the launch
// helpers, and a ring of shared-memory slots for weights too large to
// stage whole (the plain body at nf=256).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kMaxModes = 6;
constexpr int kHeadRows = 64;         // 4 rotations x 16 output lanes
// Bytes of one swizzled K-block of 64 rows x 64 columns (the output
// head's; a 128-row layer's K-blocks are twice that).
constexpr int kKBlock = 64 * 128;

// Stage-mix epilogues, in the order of unit_kernel.MIXES.
enum Mix { kNone = 0, kInner = 1, kFinal = 2, kFinalU8 = 3, kFinalPack = 4 };
// Where a pass's 4 taps come from: kSite, the (n, 16M) tap matrix; kFeature,
// the (16M, n) one; kPlane, the flat edge-padded plane; kUnit, (n, 4).
enum Src { kSite = 0, kFeature = 1, kPlane = 2, kUnit = 3 };

// Packed bf16x2 arithmetic for the head: each op rounds its exact result
// to bf16 (to nearest even).  For bf16 operands that is the float32 op
// followed by a bf16 rounding, as the JAX kernels compute it: the product
// of two bf16 values is exact in float32, and so is their sum unless the
// smaller is too small to move the larger's bf16 rounding.
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf2_relu(uint32_t a) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(0u));
  return d;
}

// bf16x2 (lo, hi) of relu(lo), relu(hi), each rounded to bf16 (a ReLU
// before or after the rounding gives the same bits up to the sign of 0).
__device__ __forceinline__ uint32_t pack_relu(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

// rows x K elements of T (bf16 or int8) into swizzled K-blocks, kblock
// bytes apart, at dst (THREADS threads of the block share the copy).  Row
// r's 16-byte chunk c (8 bf16 or 16 int8) is read from src + r*ld +
// col(r, c), in elements.  Both sides 16-byte aligned.  The copies are
// asynchronous (cp.async, all of a thread's in flight at once); the
// stager waits for them with stage_wait().
template <int THREADS, class T, class Col>
__device__ __forceinline__ void stage_sw128(unsigned char* dst, const T* src,
                                            int rows, int K, int ld,
                                            int kblock, Col col) {
  const int chunks = K * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < rows * chunks; i += THREADS) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst + sw128(r, c, kblock))),
                 "l"(src + (long long)r * ld + col(r, c))
                 : "memory");
  }
}

// Waits for this thread's stage_sw128 copies; then, with the proxy fence,
// its stores are ready for the block barrier before wgmma reads them.
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fence_async_shared();
}

// A ring of SLOTS shared-memory slots of BYTES bytes each, for operands
// too large to stage whole (plain_body.cuh's nf=256 hidden layers).  Fill
// i of a sequence lands in slot i % SLOTS, copied by the bulk-copy engine
// and announced on the slot's transaction barrier; each of WARPS warps
// reads the fills in sequence order.  A warp waits for fill i (`wait`)
// before it reads it, and releases it (`release`) once its reads are done
// (its wgmmas waited for); the release that completes fill i's count
// issues fill i + SLOTS into the slot, so no thread is set aside as a
// producer and no warp waits for another's release.  A warp releases a
// fill only after waiting for it, and fill i + SLOTS is issued only after
// every warp released fill i: the counts of two fills of one slot never
// mix, and a wait never meets a barrier two phases away.  No deadlock
// while SLOTS >= 2 and each warp holds at most two fills unreleased.
// Both run between wgmmas in flight, so neither branches within a warp.
template <int SLOTS, int BYTES, int WARPS>
struct SlotRing {
  uint32_t data;  // shared address of slot 0 (1024-byte aligned)
  uint32_t bars;  // SLOTS transaction barriers, 8 bytes apart, then SLOTS
                  // release counts, 4 bytes apart

  __device__ SlotRing(unsigned char* slots, unsigned char* barriers)
      : data(smem_u32(slots)), bars(smem_u32(barriers)) {}

  // Run by every thread before the block barrier that precedes any fill.
  __device__ void init(unsigned char* barriers) const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < SLOTS; ++s) {
        mbar_init(bars + 8 * s, 1);
        reinterpret_cast<unsigned*>(barriers + 8 * SLOTS)[s] = 0u;
      }
      mbar_init_fence();
    }
  }
  // Byte offset of fill i's slot from slot 0.
  __device__ int offset(int i) const { return (i % SLOTS) * BYTES; }
  // Fill i: BYTES from global src (16-byte aligned) into its slot; one
  // thread.
  __device__ void fill(int i, const void* src) const {
    const uint32_t bar = bars + 8 * (i % SLOTS);
    mbar_expect(bar, BYTES);
    bulk_copy(data + offset(i), src, BYTES, bar);
  }
  __device__ void wait(int i) const {
    mbar_wait(bars + 8 * (i % SLOTS), (uint32_t)(i / SLOTS) & 1u);
  }
  // Run by every thread of a warp after its reads of fill i: lane 0
  // counts the warp's release, and if it completes the count, issues fill
  // i + SLOTS from `next` (nullptr past the sequence's end).  Predicated,
  // no branch.
  __device__ void release(int i, const void* next) const {
    const uint32_t s = (uint32_t)(i % SLOTS);
    asm volatile(
        "{\n.reg .pred p, q;\n.reg .u32 old;\n"
        "setp.eq.u32 p, %0, 0;\n"
        "mov.u32 old, 0;\n"
        "@p atom.shared.inc.u32 old, [%1], %2;\n"
        "setp.eq.and.u32 q, old, %2, p;\n"
        "setp.ne.and.u64 q, %3, 0, q;\n"
        "@q mbarrier.arrive.expect_tx.shared::cta.b64 _, [%4], %5;\n"
        "@q cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%6], [%3], %5, [%4];\n}\n" ::"r"(threadIdx.x & 31),
        "r"(bars + 8 * SLOTS + 4 * s), "r"(WARPS - 1), "l"(next),
        "r"(bars + 8 * s), "r"(BYTES), "r"(data + s * BYTES)
        : "memory");
  }
};

// The bf16 head's weights as feature pairs: w1 (nf, 4) -> sW1[k][nf/2]
// (features 2q, 2q+1 of tap k in one word), b1 (nf,) -> sB1[nf/2].
template <int THREADS, int NF>
__device__ __forceinline__ void stage_head_pairs(uint32_t* sW1, uint32_t* sB1,
                                                 const __nv_bfloat16* w1,
                                                 const __nv_bfloat16* b1) {
  for (int i = threadIdx.x; i < 4 * NF / 2; i += THREADS) {
    const int k = i / (NF / 2), f = 2 * (i % (NF / 2));  // i = k*NF/2 + f/2
    sW1[i] = bits(w1[f * 4 + k]) | bits(w1[(f + 1) * 4 + k]) << 16;
  }
  for (int i = threadIdx.x; i < NF / 2; i += THREADS)
    sB1[i] = bits(b1[2 * i]) | bits(b1[2 * i + 1]) << 16;
}

// The 4 taps of site s for pass column block col, each as a bf16 in both
// halves of a word; 0 for a site past n and, on the plane, for a tap
// outside [0, n) (the TPU's zero-padded windows).  kSite reads row s of
// the (n, 16 modes) matrix, kUnit of the (n, 4) one, kFeature rows col ..
// col+3 of the (16 modes, n) one, kPlane s + sOff[col + k].
template <int SRC>
__device__ __forceinline__ void load_taps2(const __nv_bfloat16* taps,
                                           long long n, int modes,
                                           const int* sOff, long long s,
                                           int col, uint32_t (&tb)[4]) {
  if constexpr (SRC == kSite || SRC == kUnit) {
    uint2 raw = make_uint2(0u, 0u);
    if (s < n)
      raw = *reinterpret_cast<const uint2*>(
          taps + (SRC == kUnit ? s * 4 : s * 16 * modes + col));
    tb[0] = __byte_perm(raw.x, 0, 0x1010);
    tb[1] = __byte_perm(raw.x, 0, 0x3232);
    tb[2] = __byte_perm(raw.y, 0, 0x1010);
    tb[3] = __byte_perm(raw.y, 0, 0x3232);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long q = SRC == kFeature ? s : s + sOff[col + k];
      uint32_t b = 0u;
      if (s < n && q >= 0 && q < n)
        b = bits(taps[SRC == kFeature ? (col + k) * n + q : q]);
      tb[k] = b | b << 16;
    }
  }
}

// The TPU kernels' broadcast head of a warp's sites g and g + 8 (taps tl,
// th from load_taps2) into the A fragments a[0 .. NF/16): every product
// and running sum rounded to bf16, in tap order, then + b1 in bf16, then
// ReLU, so it is bit-identical to the JAX kernels; features 2q, 2q+1 of a
// site in one bf16x2 chain.  sW1, sB1 as stage_head_pairs leaves them.
template <int NF, int KA>
__device__ __forceinline__ void bf16x2_head(const uint32_t* sW1,
                                            const uint32_t* sB1,
                                            const uint32_t (&tl)[4],
                                            const uint32_t (&th)[4], int t,
                                            uint32_t (&a)[KA][4]) {
#pragma unroll
  for (int kt = 0; kt < NF / 16; ++kt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 8 * kt + 4 * h + t;
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = sW1[k * NF / 2 + q];
      uint32_t lo = bf2_mul(tl[0], w[0]), hi = bf2_mul(th[0], w[0]);
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        lo = bf2_add(lo, bf2_mul(tl[k], w[k]));
        hi = bf2_add(hi, bf2_mul(th[k], w[k]));
      }
      a[kt][2 * h] = bf2_relu(bf2_add(lo, sB1[q]));
      a[kt][2 * h + 1] = bf2_relu(bf2_add(hi, sB1[q]));
    }
  }
}

// A layer's m64nN float32 accumulator fragment c (N = 8 NT), + its bias hb
// (float, N outputs), ReLU, bf16: the A fragments of k-tiles kt0 ..
// kt0 + NT/2 of the next product.
template <int NT, int KA>
__device__ __forceinline__ void pack_layer(const float (&c)[4 * NT],
                                           const float* hb, int t,
                                           uint32_t (&a)[KA][4], int kt0) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 b = *reinterpret_cast<const float2*>(hb + nt * 8 + 2 * t);
    const int kt = kt0 + nt / 2;
    a[kt][(nt & 1) * 2] = pack_relu(c[4 * nt] + b.x, c[4 * nt + 1] + b.y);
    a[kt][(nt & 1) * 2 + 1] =
        pack_relu(c[4 * nt + 2] + b.x, c[4 * nt + 3] + b.y);
  }
}

// The output head before its bias: NT n8 tiles (1 or 2) of the 64-row head
// whose rows start at descriptor `rows`, over the KA k-tiles of a (in
// K-blocks of kKBlock bytes).
template <int KA, int NT>
__device__ __forceinline__ void head_product(float (&c)[4 * NT],
                                             const uint32_t (&a)[KA][4],
                                             uint64_t rows) {
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) c[i] = 0.f;
  fence_operands(c);
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < KA; ++kt) {
    const uint64_t d = rows + (((kt >> 2) * kKBlock + (kt & 3) * 32) >> 4);
    if constexpr (NT == 2)
      wgmma_n16(c, a[kt], d);
    else
      wgmma_n8(c, a[kt], d);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(c);
}

// Rotation r's output lanes, round(127 tanh(.)), into the accumulator
// (acc[nt][i]: site g for i < 2 else g + 8, lane nt*8 + 2t + (i&1)).
template <int KA, int NT>
__device__ __forceinline__ void accumulate(float (&acc)[2][4],
                                           const uint32_t (&a)[KA][4],
                                           uint64_t rows, const float* b6,
                                           int t) {
  float c[4 * NT];
  head_product<KA, NT>(c, a, rows);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float o = tanhf(c[4 * nt + i] + b6[nt * 8 + 2 * t + (i & 1)]);
      acc[nt][i] += rintf(__fmul_rn(o, 127.f));
    }
  }
}

// The raw accumulator of a tile across modes, in the thread's own slots
// slot[i * 128] (so the same thread reads back what it wrote; integer
// sums, exact): mode mi adds the earlier modes' sums and keeps its own
// for the next.  True at the last mode, when acc is the whole sum.
__device__ __forceinline__ bool carry_modes(float (&acc)[2][4], float* slot,
                                            int mi, int modes) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (mi > 0) acc[i >> 2][i & 3] += slot[i * 128];
    if (mi + 1 < modes) slot[i * 128] = acc[i >> 2][i & 3];
  }
  return mi + 1 == modes;
}

// The plane's [mode][rotation][tap] offsets into shared memory.
template <int THREADS>
__device__ __forceinline__ void stage_offsets(int* sOff, const int* offs,
                                              int modes) {
  for (int i = threadIdx.x; i < modes * 16; i += THREADS) sOff[i] = offs[i];
}

// An ensemble block: GROUPS warpgroups own BLOCK consecutive sites in
// tiles of TILE, warpgroup `group` the tiles group, group + GROUPS, ...
// (the warp's rows row0 and row0 + 8 of each).  The mode loop runs outside
// the tiles: stage(mi) stages mode mi's weights between two block
// barriers, each tile's 4 passes pass(acc, s_lo, mi, r) add into the
// warp's accumulator, carried across modes in the thread's slots of sAcc
// ([tile][8][128 threads]), and at the last mode store(acc, s_lo) writes
// it.  The ragged edge: a tile that starts at or past n does not run (the
// passes read 0 and the stores skip sites past n).
template <int GROUPS, int TILE, int BLOCK, class Stage, class Pass,
          class Store>
__device__ __forceinline__ void ensemble_block(long long n, int modes,
                                               float* sAcc, int row0,
                                               Stage&& stage, Pass&& pass,
                                               Store&& store) {
  const int group = threadIdx.x >> 7;
  const int wt = threadIdx.x & 127;  // thread in the warpgroup
  const long long block0 = (long long)blockIdx.x * BLOCK;
  for (int mi = 0; mi < modes; ++mi) {
    __syncthreads();  // the previous mode's weights are no longer read
    stage(mi);
    __syncthreads();
#pragma unroll 1
    for (int j = group; j < BLOCK / TILE; j += GROUPS) {
      if (block0 + j * TILE >= n) break;
      const long long s_lo = block0 + j * TILE + row0;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 1
      for (int r = 0; r < 4; ++r) pass(acc, s_lo, mi, r);
      if (carry_modes(acc, sAcc + j * 8 * 128 + wt, mi, modes))
        store(acc, s_lo);
    }
  }
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
  if constexpr (SITE && MIX != kInner) {
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
  } else if constexpr (MIX == kFinalPack) {
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
  } else {
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
          static_cast<float*>(out_)[l * n + s] =
              rintf(__fdiv_rn(a, (float)modes));
        } else if (MIX == kFinalU8) {
          static_cast<__nv_bfloat16*>(out_)[l * n + s] =
              __float2bfloat16_rn(final_value(a, modes));
        } else if (l == 0) {  // kInner: XLA's fma(acc, 1/(4M), 127)
          const float m =
              fminf(fmaxf(rintf(__fmaf_rn(a, inv_4m, 127.f)), 0.f), 255.f);
          static_cast<__nv_bfloat16*>(out_)[s] =
              __float2bfloat16_rn(__fmul_rn(m, 1.f / 255.f));
        }
      }
    }
  }
}

// Sets kern's dynamic shared memory to smem bytes and launches it on
// `blocks` blocks; a cudaError_t.
template <class P>
int launch_kernel(void (*kern)(P), const P& p, long long blocks, int threads,
                  size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, mix>()) for a stage-mix value, kFinalPack
// only where PACK (a site-major output has no packed form); a cudaError_t.
template <bool PACK, class F>
int dispatch_mix(int mix, F&& f) {
  switch (mix) {
    case kNone: return f(std::integral_constant<int, kNone>());
    case kInner: return f(std::integral_constant<int, kInner>());
    case kFinal: return f(std::integral_constant<int, kFinal>());
    case kFinalU8: return f(std::integral_constant<int, kFinalU8>());
    case kFinalPack:
      if constexpr (PACK) return f(std::integral_constant<int, kFinalPack>());
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch checks every ensemble shares; 0 when they pass.
inline int check_ensemble(int modes, int v, long long n) {
  if (modes < 1 || modes > kMaxModes || v < 1 || v > 16 || n > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

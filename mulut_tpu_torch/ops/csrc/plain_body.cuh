// The plain-unit pass, sm_90a: one body for every bf16 kernel of plain
// (mxu-arch) units in net mode (K3 in plain_window.cu, K6 in
// plain_feature.cu, K8 in plain_site.cu), which replace the TPU kernels
// mulut_tpu/ops/unit_kernel.py:_plain_w_kernel (K3), _plain_t_kernel and
// its schedules (K6), _plain_ensemble_kernel and its schedules (K8).  For
// every site p and every pass (mode m, rotation r), with x0 its 4 taps:
//
//   x1 = bf16(relu(x0 . w1[m] + b1[m]))                    head, K = 4
//   xd = bf16(relu(x(d-1) . hw[d][m] + hb[d][m]))           depth layers
//   acc[l] += rint(127 * tanh(x_D . w6[m][:, 16r + l] + b6[m][16r + l]))
//
// then the stage mix of acc (store_mix in net_common.cuh).  Products of
// bf16 values are exact in float32 and are summed in float32, as the TPU's
// MXU dots with preferred_element_type=f32; ReLU, bias, tanh and rounding
// are float32.  Rounding is half to even (rintf), never roundf.  Build
// without --use_fast_math: tanhf, division and the inner mix's FMA must be
// IEEE (an approximate tanh's ~1e-3, times 127, would move whole percents
// of the rounded outputs).  The head above is the float32 dot (the JAX
// package's "mxu" head); K8 may take the bf16 broadcast chain instead
// (PLAIN_HEAD = "vpu", net_common.cuh's bf16x2_head), a different function.
//
// Bound: operations.  Per site and pass the hidden layers are 2*nf^2*D
// flops (65,536 at nf=128, D=2) against at most 8 bytes of taps; the
// tensor cores bound it: 5.188 ms per batch of 8 x 3 x 270 x 480 (two
// calls over 3,110,400 image sites each, 12 passes).  Beside them the
// CUDA cores run the head, each layer's bias, ReLU and bf16 packing and
// 16 tanhf per site-pass (8 at stage 1, v = 1).
//
// Design (the shape of dense_body.cuh).  A block is kGroups = 3 consumer
// warpgroups (384 threads, one block per SM) and owns kBlockSites = 768
// consecutive sites, 12 tiles of 64; a warpgroup runs a tile at a time,
// each warp 16 of its sites.  The mode loop runs outside the tiles
// (net_common.cuh's ensemble_block): each mode's weights are staged once
// per block, and the raw accumulators of the block's sites (16 float
// each, 48 KB) stay in shared memory across modes, in thread-private slots
// (exact integer sums).  Per pass:
//
//  - the float32 head runs on the CUDA cores (f32_head), each feature's 4
//    exact products summed in tap order by FMAs, + b1, written straight
//    into the first layer's A fragments; the bf16 head is the exact bf16x2
//    chain, written the same way;
//  - each hidden layer is one chain of 8 wgmma m64n128k16 with A from
//    registers (the warp's 16 x nf bf16 activations, 32 registers) and B
//    the layer's staged weights; its float32 accumulator fragment, + bias,
//    through cvt.rn.relu.bf16x2 (pack_layer), is the next layer's A, so no
//    activation touches shared or device memory;
//  - the output head is 8 wgmma m64n16k16 (m64n8k16 where v <= 8) on
//    rotation r's 16 rows of w6t, then tanhf, rintf(127 * o) and the
//    accumulate.
//
// Why the float32 head is not a tensor-core step: a wgmma m64n128k16 with
// the 4 taps in A's columns 0-3 leaves the CUDA cores less to do (K3 9.85
// ms per batch against 11.29 with this head), but the tensor cores sum the
// 4 products in another order and precision than float32 FMAs.  That
// flips more bf16 activations: at depth 3 stage 2's raw accumulator then
// came up to 7 off the plain version (the gate is 4) where this head gives
// 3, as the mma.sync body did (NVIDIA H100 80GB HBM3, chip_smoke.py
// --plain-ab; PERF.md).
//
// Each B tile is read from shared memory once per 64 sites (mma.sync read
// it once per 16), in wgmma's K-major 128-byte-swizzled layout (wgmma.cuh),
// which needs no row padding.  The warpgroups run their dependent chains
// unordered, so one's head, packing and tanh can issue while another's
// wgmmas are in flight.  A chain starts with scale-d = 0, so no chain
// zeroes its accumulator.  Staging: per block and mode the D hidden
// layers (32 KB each), the 64-row output head (16 KB), the head's weights
// (the float32 head's w1 as float, 2 KB; the bf16 head's 1.25 KB of bf16
// pairs) and the float biases: 85,760 B at depth 2, 119,040 B at depth 3.
// The weight tiles are copied with cp.async (all of a thread's copies in
// flight at once), the rest with ordinary stores, and wgmma reads them
// through the async proxy, so each staging ends with cp.async.wait_all
// and a proxy fence (stage_wait) before the block's barrier.  It is not
// overlapped with the tiles.  The ragged edge is masked per 64-site tile:
// taps past n read 0, stores past n are skipped, and a tile that starts
// past n does not run.  Depth is a runtime value, up to kMaxDepth = 4
// (199 KB of shared memory).
//
// nf = 256 (plain_wide_kernel).  One hidden layer is 256 x 256 bf16, 128
// KB: two of them, or even one beside the rest, do not fit a block's 227
// KB, and the registers hold less too.  The block, its tiles, the heads
// and the output head (64 rows x 256, 32 KB, staged per mode) stay; what
// changes:
//
//  - the hidden layers stream through a ring of kWideSlots = 5 slots of 16
//    KB (net_common.cuh's SlotRing).  A fill is the 64 rows of one quarter
//    of a layer's outputs by one half of its inputs (2 K-blocks of 64
//    rows), copied by the bulk-copy engine (cp.async.bulk, on a
//    transaction barrier) from `hws`, the layers laid out by the wrapper
//    in fill order and already swizzled (unit_kernel.ring_layers), so one
//    copy of 16 KB lands a fill as wgmma reads it.  All three warpgroups
//    read every fill, in the order mode, tile round, rotation, layer,
//    quarter, half; a warpgroup whose tile lies past n still waits for and
//    releases its round's fills.  The release that completes a fill's
//    count (4 warps x 3 warpgroups) issues the fill 5 places on into the
//    same slot;
//  - a quarter of a layer is two chains of 8 wgmma m64n64k16, one per half
//    of the inputs, each a group, summed once in float32.  The tensor
//    cores drop low bits of each step's sum, so one chain of 16 steps per
//    output (tried first) departed from exact sums far more often than
//    float32 FMAs; two of 8 and the add depart about as often (stage 2's
//    raw accumulator against float64 sums: 8.9e-4 of its entries, cuBLAS
//    float32 7.8e-4; chip_smoke.py phase 14 on an NVIDIA H100 80GB HBM3,
//    PERF.md).  After the second group is issued the first is waited for
//    and its fill released, so a warpgroup holds at most two fills;
//  - registers: the activations are 16 k-tiles (64 registers) and a
//    quarter's two partial sums 64; the packed outputs of the first three
//    quarters (48 registers) wait in shared memory, thread-private (the
//    stash, 24 KB per warpgroup, as 16-byte words 128 threads apart,
//    conflict-free), and are read back after the last quarter's chains;
//  - the raw accumulator stays in shared memory across rotations as well
//    as modes, as int16 (exact), so it takes no registers during chains.
//
// Shared memory at nf=256: output head 32 KB, accumulators 24 KB, stash
// 72 KB, vectors 9.6 KB, barriers, ring 80 KB: 224,256 B with the
// alignment, at any depth.  The bound: the same operations, 20.27 ms per
// batch at nf=256, depth 2; beside it each fill is read from L2 by every
// block for 192 site-passes, ~51 GB per stage call.
//
// Measured: PERF.md (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W).
//
// Template parameters pick where the taps come from (SRC), the head (HEAD)
// and how the accumulator leaves (MIX, feature- or site-major by SRC);
// everything else is the same code, so K6 and K8 with the float32 head
// return K3's accumulator bit for bit.  The TPU's schedule variants of
// these kernels (rs, rsiv, iv, ivg*) only reorder its instructions and
// give the same outputs; this one body stands for all of them.

#pragma once

#include "net_common.cuh"

struct PlainParams {
  // kPlane: the flat edge-padded plane (n,); kFeature: the (16M, n) tap
  // matrix; kSite: the (n, 16M) one (8-byte aligned)
  const __nv_bfloat16* taps;
  const __nv_bfloat16* w1t;    // (M, nf, 4)
  const __nv_bfloat16* b1;     // (M, nf)
  const __nv_bfloat16* hwt;    // (D, M, nf, nf): [d][m][out][in]
  const __nv_bfloat16* hws;    // nf=256: hwt in fill order, swizzled
                               // (unit_kernel.ring_layers); else unused
  const __nv_bfloat16* hb;     // (D, M, nf)
  const __nv_bfloat16* w6t;    // (M, 64, nf): row 16*r + lane
  const __nv_bfloat16* b6;     // (M, 64)
  void* out;                   // see the entry points
  long long n;
  int modes, depth, v;
  float inv_4m;                // float32(1 / (4M))
  int offs[kMaxModes * 16];    // kPlane: [mode][rotation][tap] offsets
};

namespace {

// The head of a pass, in the order of unit_kernel.HEADS.
enum Head { kHeadF32 = 0, kHeadBf16 = 1 };

// Launch geometry (chip_smoke.plain_grid and friends are its Python copy).
constexpr int kGroups = 3;                      // warpgroups per block
constexpr int kPlainThreads = 128 * kGroups;
constexpr int kTile = 64;                       // sites per warpgroup tile
constexpr int kBlockSites = 768;                // sites per block
constexpr int kPlainNF = 128;                   // the layout's nf
constexpr int kMaxDepth = 4;

// Shared layout from a 1024-byte-aligned base: the output head w6t[m] as
// 2 swizzled K-blocks of 64 rows; the raw accumulators [tile][8][128
// threads]; the vectors (b1, b6 and the hidden biases [kMaxDepth][nf] as
// float; the head's weights, for the float32 head w1 as float [nf][4], for
// the bf16 head w1 [4][nf/2] and b1 [nf/2] as bf16 pairs; the plane
// offsets); then hidden layer d at kLayerBase + d * kLayerBytes, 2
// K-blocks of nf rows.
constexpr int kLayerKBlock = kPlainNF * 128;    // nf rows x 64 columns
constexpr int kLayerBytes = 2 * kLayerKBlock;
constexpr int kW6Base = 0;
constexpr int kAccBase = kW6Base + 2 * kKBlock;
constexpr int kVecBase = kAccBase + kBlockSites * 16 * 4;
constexpr int kVecBytes = (kPlainNF + kHeadRows + kMaxDepth * kPlainNF +
                           4 * kPlainNF + kMaxModes * 16) * 4;
constexpr int kLayerBase = (kVecBase + kVecBytes + 1023) / 1024 * 1024;

constexpr size_t smem_bytes(int depth) {
  return (size_t)kLayerBase + (size_t)depth * kLayerBytes +
         1024;  // room to align the base
}

// The nf=256 layout from a 1024-byte-aligned base: the output head w6t[m]
// as 4 swizzled K-blocks of 64 rows; the raw accumulators [tile][8][128
// threads] as int16 (integers of at most 4 * 6 * 127); the stash
// [group][12 k-tiles][128 threads] of 16-byte words; the vectors at
// nf=256; the ring's barriers and release counts; then the ring, per slot
// the 64 rows of one quarter of a layer's outputs by one half of its
// inputs, as 2 swizzled K-blocks of 64 rows.
constexpr int kWideNF = 256;
constexpr int kWideSlots = 5;
constexpr int kWideSlotBytes = 2 * kKBlock;
constexpr int kWideW6Base = 0;
constexpr int kWideAccBase = kWideW6Base + 4 * kKBlock;
constexpr int kStashBase = kWideAccBase + kBlockSites * 16 * 2;
constexpr int kStashBytes = kGroups * 12 * 128 * 16;
constexpr int kWideVecBase = kStashBase + kStashBytes;
constexpr int kWideVecBytes = (kWideNF + kHeadRows + kMaxDepth * kWideNF +
                               4 * kWideNF + kMaxModes * 16) * 4;
constexpr int kBarBase = kWideVecBase + kWideVecBytes;
constexpr int kRingBase = (kBarBase + kWideSlots * 12 + 1023) / 1024 * 1024;
constexpr int kWideSmem = kRingBase + kWideSlots * kWideSlotBytes + 1024;
static_assert(kWideSmem <= 232448, "a block's shared memory");

// The ring of the nf=256 layers: every warp of the block reads each fill.
using WideRing = SlotRing<kWideSlots, kWideSlotBytes, 4 * kGroups>;

// The vectors' shared arrays at `base` (layouts above).
template <int NF>
struct Vecs {
  float* b1;      // [nf] (the float32 head at nf=128)
  float* b6;      // [64]
  float* hb;      // [kMaxDepth][nf]
  uint32_t* w1;   // the float32 head at nf=128: float [nf][4]; else
                  // bf16 pairs [4][nf/2], then b1's pairs [nf/2]
  int* offs;      // [kMaxModes][16]

  __device__ explicit Vecs(unsigned char* base)
      : b1(reinterpret_cast<float*>(base)),
        b6(b1 + NF),
        hb(b6 + kHeadRows),
        w1(reinterpret_cast<uint32_t*>(hb + kMaxDepth * NF)),
        offs(reinterpret_cast<int*>(w1 + 4 * NF)) {}
};

// Mode mi's weights into shared memory (layout above).  The caller's
// __syncthreads() after it, with each thread's proxy fence here, orders
// the stores before any warpgroup's wgmma reads them.
template <int NF, int HEAD>
__device__ __forceinline__ void stage_mode(const PlainParams& p, int mi,
                                           unsigned char* sm,
                                           const Vecs<NF>& v) {
  const auto rows = [](int, int c) { return 8 * c; };
  for (int d = 0; d < p.depth; ++d)
    stage_sw128<kPlainThreads>(
        sm + kLayerBase + d * kLayerBytes,
        p.hwt + ((long long)d * p.modes + mi) * NF * NF, NF, NF, NF,
        kLayerKBlock, rows);
  stage_sw128<kPlainThreads>(sm + kW6Base,
                             p.w6t + (long long)mi * kHeadRows * NF,
                             kHeadRows, NF, NF, kKBlock, rows);
  const __nv_bfloat16* w1 = p.w1t + (long long)mi * NF * 4;
  if (HEAD == kHeadF32) {
    float* sW1 = reinterpret_cast<float*>(v.w1);
    for (int i = threadIdx.x; i < NF * 4; i += kPlainThreads)
      sW1[i] = __bfloat162float(w1[i]);
    for (int i = threadIdx.x; i < NF; i += kPlainThreads)
      v.b1[i] = __bfloat162float(p.b1[mi * NF + i]);
  } else {
    stage_head_pairs<kPlainThreads, NF>(v.w1, v.w1 + 2 * NF, w1,
                                        p.b1 + mi * NF);
  }
  for (int i = threadIdx.x; i < p.depth * NF; i += kPlainThreads) {
    const int d = i / NF;
    v.hb[i] = __bfloat162float(
        p.hb[((long long)d * p.modes + mi) * NF + (i - d * NF)]);
  }
  for (int i = threadIdx.x; i < kHeadRows; i += kPlainThreads)
    v.b6[i] = __bfloat162float(p.b6[mi * kHeadRows + i]);
  stage_wait();  // the copies and stores above, before wgmma reads them
}

// stage_mode at nf=256: mode mi's output head and vectors (the layers go
// through the ring), in loops that are not unrolled, so that no trip
// count of theirs stays live across the tiles (ptxas spilled them when
// they were).  Both heads read w1 and b1 as bf16 pairs (stage_head_pairs'
// layout): the float32 head widens them itself (f32_head_pairs).
__device__ __forceinline__ void stage_wide(const PlainParams& p, int mi,
                                           unsigned char* sm,
                                           const Vecs<kWideNF>& v) {
  constexpr int NF = kWideNF;
  const __nv_bfloat16* w6 = p.w6t + (long long)mi * kHeadRows * NF;
#pragma unroll 1
  for (int i = threadIdx.x; i < kHeadRows * NF / 8; i += kPlainThreads) {
    const int r = i / (NF / 8), c = i % (NF / 8);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(sm + kWideW6Base + sw128(r, c, kKBlock))),
                 "l"(w6 + r * NF + 8 * c)
                 : "memory");
  }
  const __nv_bfloat16* w1 = p.w1t + (long long)mi * NF * 4;
  const __nv_bfloat16* b1 = p.b1 + (long long)mi * NF;
#pragma unroll 1
  for (int i = threadIdx.x; i < 4 * NF / 2; i += kPlainThreads) {
    const int k = i / (NF / 2), f = 2 * (i % (NF / 2));
    v.w1[i] = bits(w1[f * 4 + k]) | bits(w1[(f + 1) * 4 + k]) << 16;
  }
#pragma unroll 1
  for (int i = threadIdx.x; i < NF / 2; i += kPlainThreads)
    v.w1[2 * NF + i] = bits(b1[2 * i]) | bits(b1[2 * i + 1]) << 16;
#pragma unroll 1
  for (int i = threadIdx.x; i < p.depth * NF; i += kPlainThreads) {
    const int d = i / NF;
    v.hb[i] = __bfloat162float(
        p.hb[((long long)d * p.modes + mi) * NF + (i - d * NF)]);
  }
#pragma unroll 1
  for (int i = threadIdx.x; i < kHeadRows; i += kPlainThreads)
    v.b6[i] = __bfloat162float(p.b6[mi * kHeadRows + i]);
  stage_wait();  // the copies and stores above, before wgmma reads them
}

// x . w, the 4 products (exact in float32) summed in tap order.
__device__ __forceinline__ float dot4(const float (&x)[4], float4 w) {
  return __fmaf_rn(x[3], w.w,
                   __fmaf_rn(x[2], w.z, __fmaf_rn(x[1], w.y,
                                                  __fmul_rn(x[0], w.x))));
}

// The float32 head of a warp's sites g and g + 8 (taps tl, th from
// load_taps2) into the A fragments a[0 .. NF/16): feature f of a site is
// bf16(relu(dot4 + b1[f])), features 2q, 2q+1 in one word.  sW1: w1 as
// float [nf][4].
template <int NF, int KA>
__device__ __forceinline__ void f32_head(const float4* sW1, const float* sB1,
                                         const uint32_t (&tl)[4],
                                         const uint32_t (&th)[4], int t,
                                         uint32_t (&a)[KA][4]) {
  float xl[4], xh[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    xl[k] = __uint_as_float(tl[k] << 16);
    xh[k] = __uint_as_float(th[k] << 16);
  }
#pragma unroll
  for (int kt = 0; kt < NF / 16; ++kt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = 16 * kt + 8 * h + 2 * t;
      const float4 w0 = sW1[f], w1 = sW1[f + 1];
      const float2 b = *reinterpret_cast<const float2*>(sB1 + f);
      a[kt][2 * h] = pack_relu(dot4(xl, w0) + b.x, dot4(xl, w1) + b.y);
      a[kt][2 * h + 1] = pack_relu(dot4(xh, w0) + b.x, dot4(xh, w1) + b.y);
    }
  }
}

// f32_head from w1 and b1 as bf16 pairs (stage_head_pairs' layout: sW1
// [4][nf/2], sB1 [nf/2], features 2q and 2q+1 in word q): the same float32
// values, so the same sums bit for bit, in half the registers a float4
// pair of w1 rows takes.
template <int NF, int KA>
__device__ __forceinline__ void f32_head_pairs(const uint32_t* sW1,
                                               const uint32_t* sB1,
                                               const uint32_t (&tl)[4],
                                               const uint32_t (&th)[4],
                                               int t, uint32_t (&a)[KA][4]) {
  float xl[4], xh[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    xl[k] = __uint_as_float(tl[k] << 16);
    xh[k] = __uint_as_float(th[k] << 16);
  }
#pragma unroll
  for (int kt = 0; kt < NF / 16; ++kt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 8 * kt + 4 * h + t;  // features 2q, 2q + 1
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = sW1[k * NF / 2 + q];
      const float4 w0 = make_float4(
          __uint_as_float(w[0] << 16), __uint_as_float(w[1] << 16),
          __uint_as_float(w[2] << 16), __uint_as_float(w[3] << 16));
      const float4 w1 = make_float4(
          __uint_as_float(w[0] & 0xFFFF0000u),
          __uint_as_float(w[1] & 0xFFFF0000u),
          __uint_as_float(w[2] & 0xFFFF0000u),
          __uint_as_float(w[3] & 0xFFFF0000u));
      const uint32_t bq = sB1[q];
      const float b0 = __uint_as_float(bq << 16);
      const float b1 = __uint_as_float(bq & 0xFFFF0000u);
      a[kt][2 * h] = pack_relu(dot4(xl, w0) + b0, dot4(xl, w1) + b1);
      a[kt][2 * h + 1] = pack_relu(dot4(xh, w0) + b0, dot4(xh, w1) + b1);
    }
  }
}

// One block per SM (135 KB of shared memory at depth 2, 199 KB at 4), so
// the minimum of 1 block lets ptxas give each of the 384 threads up to 168
// registers for the activations (32), a layer's accumulator (64) and the
// addressing.
template <int NF, int SRC, int MIX, int HEAD>
__global__ void __launch_bounds__(kPlainThreads, 1)
plain_kernel(const PlainParams p) {
  static_assert(NF == kPlainNF, "the layout takes 128-row layers and n128");
  constexpr int KT = NF / 16;  // k-tiles of an activation
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint64_t desc = sw128_desc(smem_u32(sm));
  const Vecs<NF> v(sm + kVecBase);

  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  // the warp's 16 rows of the tile
  const int row0 = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const bool wide = p.v > 8;  // two n8 tiles of output lanes

  if (SRC == kPlane) stage_offsets<kPlainThreads>(v.offs, p.offs, p.modes);

  // a layer's accumulator; each chain's first wgmma overwrites it
  float c[NF / 2];
#pragma unroll
  for (int i = 0; i < NF / 2; ++i) c[i] = 0.f;

  ensemble_block<kGroups, kTile, kBlockSites>(
      p.n, p.modes, reinterpret_cast<float*>(sm + kAccBase), row0,
      [&](int mi) { stage_mode<NF, HEAD>(p, mi, sm, v); },
      [&](float (&acc)[2][4], long long s_lo, int mi, int r) {
        const int col = (mi * 4 + r) * 4;
        uint32_t tl[4], th[4];
        load_taps2<SRC>(p.taps, p.n, p.modes, v.offs, s_lo, col, tl);
        load_taps2<SRC>(p.taps, p.n, p.modes, v.offs, s_lo + 8, col, th);
        uint32_t a[KT][4];
        if (HEAD == kHeadF32)
          f32_head<NF>(reinterpret_cast<const float4*>(v.w1), v.b1, tl, th,
                       t, a);
        else
          bf16x2_head<NF>(v.w1, v.w1 + 2 * NF, tl, th, t, a);
#pragma unroll 1
        for (int d = 0; d < p.depth; ++d) {
          const uint64_t w = desc + ((kLayerBase + d * kLayerBytes) >> 4);
          wgmma_fence();
#pragma unroll
          for (int kt = 0; kt < KT; ++kt)
            wgmma_n128(c, a[kt],
                       w + (((kt >> 2) * kLayerKBlock + (kt & 3) * 32) >> 4),
                       kt);
          wgmma_commit();
          wgmma_wait_all();
          fence_operands(c);
          pack_layer<NF / 8>(c, v.hb + d * NF, t, a, 0);
        }
        const uint64_t rows = desc + ((kW6Base + r * 16 * 128) >> 4);
        if (wide)
          accumulate<KT, 2>(acc, a, rows, v.b6 + 16 * r, t);
        else
          accumulate<KT, 1>(acc, a, rows, v.b6 + 16 * r, t);
      },
      [&](const float (&acc)[2][4], long long s_lo) {
        store_mix<MIX, SRC == kSite>(acc, p.out, p.n, s_lo, s_lo + 8, t,
                                     p.modes, p.inv_4m);
      });
}

// One quarter of a layer at nf=256 (64 outputs) over fills i and i+1 of
// the ring (its rows by inputs 0-127 and 128-255, at pass positions u and
// u+1): two chains of 8 wgmma m64n64k16, p0 over a's k-tiles 0-7 and p1
// over 8-15, each a group; after the second is issued the first is waited
// for and its fill released.  The quarter's sum is p0 + p1, rounded once
// in float32: a chain of 16 steps loses more to the tensor cores' sums
// than two of 8 and one add.
template <class Next>
__device__ __forceinline__ void quarter_chain(float (&c)[32],
                                              const uint32_t (&a)[16][4],
                                              const WideRing& ring,
                                              uint64_t slot0, int i, int u,
                                              Next&& next) {
  float p0[32], p1[32];
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    ring.wait(i + j);
    const uint64_t b = slot0 + (ring.offset(i + j) >> 4);
    float (&p)[32] = j ? p1 : p0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint64_t d = b + (((k >> 2) * kKBlock + (k & 3) * 32) >> 4);
      if (k == 0)
        wgmma_n64_first(p, a[8 * j], d);
      else
        wgmma_n64(p, a[8 * j + k], d);
    }
    wgmma_commit();
  }
  wgmma_wait<1>();
  ring.release(i, next(u));
  wgmma_wait<0>();
  ring.release(i + 1, next(u + 1));
  fence_operands(p0);
  fence_operands(p1);
#pragma unroll
  for (int e = 0; e < 32; ++e) c[e] = p0[e] + p1[e];
}

// The pass at nf=256 (the layout and the ring above; the same function
// as plain_kernel's).  One block per SM (224,256 B of shared memory), 384
// threads of up to 168 registers: the activations (64), a quarter's two
// partial sums (64), the addressing.  The raw accumulator lives in its
// shared slots (sAcc) across rotations as well as modes, so it takes no
// registers while the chains run (integer sums, exact in any order).
template <int SRC, int MIX, int HEAD>
__global__ void __launch_bounds__(kPlainThreads, 1)
plain_wide_kernel(const PlainParams p) {
  static_assert(kWideSlots < 8, "a fill's successor lies at most one pass on");
  constexpr int NF = kWideNF;
  constexpr int KT = NF / 16;  // k-tiles of an activation
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint64_t desc = sw128_desc(smem_u32(sm));
  const uint64_t slot0 = desc + (kRingBase >> 4);
  const Vecs<NF> v(sm + kWideVecBase);
  const WideRing ring(sm + kRingBase, sm + kBarBase);

  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int group = threadIdx.x >> 7;
  const int wt = threadIdx.x & 127;  // thread in the warpgroup
  // the warp's 16 rows of the tile
  const int row0 = (wt >> 5) * 16 + (lane >> 2);
  const bool wide = p.v > 8;  // two n8 tiles of output lanes
  // this thread's stash words, k-tile kt at stash[kt * 128]
  uint4* stash = reinterpret_cast<uint4*>(sm + kStashBase) +
                 group * 12 * 128 + wt;

  if (SRC == kPlane) stage_offsets<kPlainThreads>(v.offs, p.offs, p.modes);
  ring.init(sm + kBarBase);
  __syncthreads();

  // Every warpgroup runs `rounds` tile rounds per mode, tile group +
  // kGroups * round, live while it starts before n.  A pass reads
  // per_pass fills, at pass position u = 8 * layer + 2 * quarter + half.
  const long long block0 = (long long)blockIdx.x * kBlockSites;
  const int live_tiles = (int)min((long long)(kBlockSites / kTile),
                                  (p.n - block0 + kTile - 1) / kTile);
  const int rounds = (live_tiles + kGroups - 1) / kGroups;
  const int per_pass = 8 * p.depth;
  // hws holds mode mi's fills at mi * per_pass + u, 16 KB each
  const auto src = [&](int f) {
    return p.hws + (long long)f * (kWideSlotBytes / 2);
  };
  if (threadIdx.x == 0)
    for (int f = 0; f < min(kWideSlots, p.modes * rounds * 4 * per_pass);
         ++f)
      ring.fill(f, src(f));

  int i = 0;  // the next fill, in the sequence every warp walks
  for (int mi = 0; mi < p.modes; ++mi) {
    __syncthreads();  // the previous mode's weights are no longer read
    stage_wide(p, mi, sm, v);
    __syncthreads();
#pragma unroll 1
    for (int round = 0; round < rounds; ++round) {
      const int j = group + kGroups * round;
      const bool live = j < live_tiles;
      short* slot = reinterpret_cast<short*>(sm + kWideAccBase) +
                    j * 8 * 128 + wt;
#pragma unroll 1
      for (int r = 0; r < 4; ++r) {
        // the source of the fill kWideSlots places after pass position u
        // of this pass: in the next pass past the pass's end (the same
        // fills again, but in the next mode's after the mode's last
        // pass), none past the last mode's
        const bool last = r == 3 && round == rounds - 1;
        const auto next = [&](int u) -> const __nv_bfloat16* {
          const int uf = u + kWideSlots;
          const int f = mi * per_pass + uf -
                        (uf >= per_pass && !last ? per_pass : 0);
          return f < p.modes * per_pass ? src(f) : nullptr;
        };
        if (!live) {  // no tile: only wait for and release the fills
#pragma unroll 1
          for (int u = 0; u < per_pass; ++u, ++i) {
            ring.wait(i);
            ring.release(i, next(u));
          }
          continue;
        }
        const long long s_lo = block0 + j * kTile + row0;
        const int col = (mi * 4 + r) * 4;
        uint32_t tl[4], th[4];
        load_taps2<SRC>(p.taps, p.n, p.modes, v.offs, s_lo, col, tl);
        load_taps2<SRC>(p.taps, p.n, p.modes, v.offs, s_lo + 8, col, th);
        uint32_t a[KT][4];
        if (HEAD == kHeadF32)
          f32_head_pairs<NF>(v.w1, v.w1 + 2 * NF, tl, th, t, a);
        else
          bf16x2_head<NF>(v.w1, v.w1 + 2 * NF, tl, th, t, a);
#pragma unroll 1
        for (int d = 0; d < p.depth; ++d, i += 8) {
          // outputs 0-191 packed into the stash, 192-255 into a's last 4
          // k-tiles once the last quarter's chains no longer read a
#pragma unroll 1
          for (int q = 0; q < 3; ++q) {
            float c[32];
            quarter_chain(c, a, ring, slot0, i + 2 * q, 8 * d + 2 * q, next);
            uint32_t out[4][4];
            pack_layer<8>(c, v.hb + d * NF + 64 * q, t, out, 0);
#pragma unroll
            for (int kt = 0; kt < 4; ++kt)
              stash[(4 * q + kt) * 128] =
                  make_uint4(out[kt][0], out[kt][1], out[kt][2], out[kt][3]);
          }
          float c[32];
          quarter_chain(c, a, ring, slot0, i + 6, 8 * d + 6, next);
          pack_layer<8>(c, v.hb + d * NF + 192, t, a, 12);
#pragma unroll
          for (int kt = 0; kt < 12; ++kt) {
            const uint4 w = stash[kt * 128];
            a[kt][0] = w.x;
            a[kt][1] = w.y;
            a[kt][2] = w.z;
            a[kt][3] = w.w;
          }
        }
        float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const uint64_t rows = desc + ((kWideW6Base + r * 16 * 128) >> 4);
        if (wide)
          accumulate<KT, 2>(o, a, rows, v.b6 + 16 * r, t);
        else
          accumulate<KT, 1>(o, a, rows, v.b6 + 16 * r, t);
        const bool first = mi == 0 && r == 0;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          slot[e * 128] = (short)((first ? 0 : (int)slot[e * 128]) +
                                  (int)o[e >> 2][e & 3]);
      }
      if (live && mi + 1 == p.modes) {
        float acc[2][4];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e >> 2][e & 3] = (float)slot[e * 128];
        const long long s_lo = block0 + j * kTile + row0;
        store_mix<MIX, SRC == kSite>(acc, p.out, p.n, s_lo, s_lo + 8, t,
                                     p.modes, p.inv_4m);
      }
    }
  }
}

// The stage-mix instances of one width, tap source and head; a site-major
// output has no packed form.
template <int NF, int SRC, int HEAD>
int launch_mix(const PlainParams& p, int mix, cudaStream_t s) {
  const long long blocks = (p.n + kBlockSites - 1) / kBlockSites;
  return dispatch_mix<SRC != kSite>(mix, [&](auto m) {
    if constexpr (NF == kWideNF)
      return launch_kernel(plain_wide_kernel<SRC, decltype(m)::value, HEAD>,
                           p, blocks, kPlainThreads, (size_t)kWideSmem, s);
    else
      return launch_kernel(plain_kernel<NF, SRC, decltype(m)::value, HEAD>,
                           p, blocks, kPlainThreads, smem_bytes(p.depth), s);
  });
}

// Checks shared by the entry points; 0 when p may be launched at nf.
inline int check_params(const PlainParams* p, int nf) {
  if (p->depth < 0 || p->depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  if (nf == kWideNF &&
      (p->hws == nullptr || reinterpret_cast<uintptr_t>(p->hws) % 16))
    return (int)cudaErrorInvalidValue;
  return check_ensemble(p->modes, p->v, p->n);
}

}  // namespace

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

// The vectors' shared arrays (layout above).
struct Vecs {
  float* b1;      // [nf]
  float* b6;      // [64]
  float* hb;      // [kMaxDepth][nf]
  uint32_t* w1;   // float32 head: float [nf][4]; bf16 head: [4][nf/2]
  int* offs;      // [kMaxModes][16]

  __device__ explicit Vecs(unsigned char* sm)
      : b1(reinterpret_cast<float*>(sm + kVecBase)),
        b6(b1 + kPlainNF),
        hb(b6 + kHeadRows),
        w1(reinterpret_cast<uint32_t*>(hb + kMaxDepth * kPlainNF)),
        offs(reinterpret_cast<int*>(w1 + 4 * kPlainNF)) {}
};

// Mode mi's weights into shared memory (layout above).  The caller's
// __syncthreads() after it, with each thread's proxy fence here, orders
// the stores before any warpgroup's wgmma reads them.
template <int NF, int HEAD>
__device__ __forceinline__ void stage_mode(const PlainParams& p, int mi,
                                           unsigned char* sm, const Vecs& v) {
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
  const Vecs v(sm);

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

// The stage-mix instances of one tap source and head; a site-major output
// has no packed form.
template <int NF, int SRC, int HEAD>
int launch_mix(const PlainParams& p, int mix, cudaStream_t s) {
  const long long blocks = (p.n + kBlockSites - 1) / kBlockSites;
  return dispatch_mix<SRC != kSite>(mix, [&](auto m) {
    return launch_kernel(plain_kernel<NF, SRC, decltype(m)::value, HEAD>, p,
                         blocks, kPlainThreads, smem_bytes(p.depth), s);
  });
}

// Checks shared by the entry points; 0 when p may be launched.
inline int check_params(const PlainParams* p) {
  if (p->depth < 0 || p->depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  return check_ensemble(p->modes, p->v, p->n);
}

}  // namespace

// The dense-concat unit pass, sm_90a: one body for every dense-unit kernel
// of net mode (K4, K5, K7, K9 in dense_ensemble.cu, dense_window.cu,
// dense_feature.cu; K10 in dense_unit.cu).  For every site n and pass
// (mode m, rotation r), with t its 4 bf16 taps:
//
//   c1 = relu(bf16 chain: sum_k bf16(t[k] * w1[m][k]), then + b1[m])
//   c_l = bf16(relu([c1 .. c_(l-1)] . w_(l+1)[m] + b_(l+1)[m])),  l = 2..5
//   acc[n][j] += rint(127 * tanh([c1 .. c5] . w6[m][:, 16r + j] + b6[..]))
//
// The head is the TPU kernels' broadcast form: every product and every
// running sum is rounded to bf16, in tap order, then + b1 in bf16, then
// ReLU, so it is bit-identical to the JAX kernels.  It stays on the CUDA
// cores (a K=4 tensor-core product sums in float32, which is another
// function), two features per instruction in packed bf16x2 arithmetic.
// The concat layers and the output head are bf16 products summed in
// float32; tanh and rounding (half to even) are float32.  Build without
// --use_fast_math.
//
// Bound: operations.  Per site and pass the concat layers are
// 2*nf^2*(1+2+3+4) flops (81,920 at nf=64) and the output head 2*5nf*v,
// against at most 96 bytes of taps per site for all 12 passes: at the
// bench's 8 x 3 x 270 x 480 an ensemble call is 3,110,400 sites x 12
// passes, 3.1-3.5 ms of tensor work at the dense bf16 peak.  Beside it
// the CUDA cores run the head, the bias/ReLU/bf16 packing of each layer
// and 16 tanhf per site-pass (8 where v <= 8).
//
// Design.  A block is kGroups = 3 consumer warpgroups (384 threads, one
// block per SM); a warpgroup owns a tile of 64 consecutive sites, each of
// its warps 16 of them.  Per pass the warp computes the head into the A
// fragments of the first concat slot, then each concat layer is one chain
// of wgmma m64n64k16 with A from registers (the warps' whole (16, 5nf)
// concat, a[5nf/16][4], 80 registers at nf=64) and B the layer's staged
// weights; its float32 accumulator fragment, + bias, ReLU, packed to
// bf16, is the A fragment of the next k-tiles, so no activation touches
// shared or device memory.  The output head is m64n16k16 (m64n8k16 where
// v <= 8).  Each B tile is read from shared memory once per 64 sites
// (mma.sync read it once per 16), in wgmma's K-major 128-byte-swizzled
// layout (wgmma.cuh), which needs no row padding.  The warpgroups run
// their dependent layer chains independently, so one's head, tanh and
// packing can issue while another's wgmmas are in flight.  They are not
// ordered in turns (no ping-pong over named barriers); no committed
// measurement compares that order, or two warpgroups, with this one.
//
// Staging.  The weights of one mode (w2..w5 80 KB, the 64-row output head
// 40 KB, w1 and b1 as bf16 pairs and the other biases as float, 2 KB)
// are copied to shared memory once per block and mode.  K10 (one mode)
// runs persistent blocks, one per SM, each staging its unit once and
// walking 64-site tiles: 132 x 88.7-93.9 KB, ~12 MB per call (6 calls:
// ~72 MB per batch; the mma.sync body staged ~51 GB).  The ensembles (3
// modes, 3 x 122 KB, more than a block's 227 KB) give a block kBlockSites
// = 768 sites and run the mode loop outside its 12 tiles, the raw
// accumulators of its sites (16 float each, 48 KB) kept in shared memory
// across modes: 4,050 blocks x 3 x 124,800 B, ~1.52 GB per call and ~3.03
// GB per batch (the mma.sync body, 128 sites per block: ~17.9 GB).  The
// mode's staging is not overlapped with its first tiles.  The weights
// are written with ordinary stores and read by wgmma through the async
// proxy, so each staging ends with a proxy fence (fence_async_shared)
// before the block's barrier; the ensembles restage the same bytes for
// every mode, and without the fence a wgmma could read the last mode's.
//
// Template parameters pick where the taps come from (SRC), how the
// accumulator leaves (MIX) and how the weights are laid out (PAIRED).
// Everything from the staged weights on (the head, the wgmma chains in
// the same k order, the tanh, the accumulation) is the same code for all
// of them, and K9's staging copies its diagonal blocks into K4's layout,
// so K5, K7 and K9 return K4's accumulator bit for bit.  The ragged edge
// is masked per 64-site tile: taps past n read 0, stores past n are
// skipped, and tiles that start past n are not run.

#pragma once

#include "net_common.cuh"
#include "wgmma.cuh"

struct DenseParams {
  // kSite: (n, 16M) tap matrix; kFeature: (16M, n); kPlane: the flat
  // edge-padded plane (n,); kUnit: (n, 4)
  const __nv_bfloat16* taps;
  const __nv_bfloat16* w1t;    // (M, nf, 4)
  const __nv_bfloat16* b1;     // (M, nf)
  // layer l = 2..5: (M, nf, (l-1)*nf), [out][in]; paired: (M, 2nf,
  // 2(l-1)nf), block diagonal (pair_stage_params, transposed)
  const __nv_bfloat16* wt[4];
  const __nv_bfloat16* hb[4];  // (M, nf); paired: (M, 2nf), [b b]
  // (M, 64, 5nf), row 16*r + lane; paired: (M, 64, 10nf); kUnit: (1, v, 5nf)
  const __nv_bfloat16* w6t;
  const __nv_bfloat16* b6;     // (M, 64); kUnit: (1, v)
  void* out;                   // see the entry points
  long long n;
  int modes, v;
  float inv_4m;                // float32(1 / (4M)), the inner mix
  int offs[kMaxModes * 16];    // kPlane: [mode][rotation][tap] offsets
};

namespace {

// MIX value of the site-major raw accumulator, (n, 16) float32 (K4, K9);
// kNone .. kFinalPack write feature-major through store_mix (K5, K7).
constexpr int kSiteAcc = 5;

// Launch geometry (unit_kernel.dense_tiles is its Python copy).
constexpr int kGroups = 3;                      // warpgroups per block
constexpr int kDenseThreads = 128 * kGroups;
constexpr int kTile = 64;                       // sites per warpgroup tile
constexpr int kBlockSites = 768;                // sites per ensemble block
constexpr int kBlockTiles = kBlockSites / kTile;

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

// Shared layout from a 1024-byte-aligned base: concat layer l = 1..4
// (slot l <- layer l+1) as l swizzled K-blocks of 64 rows x 64 columns,
// the output head as 5 K-blocks of 64 rows (a unit's v rows use the first
// v), then w1 as bf16 feature pairs [4][nf/2] and b1 as pairs [nf/2]
// (32-bit words), float hidden biases [4][nf] and b6 [64], the plane
// offsets, and for the ensembles the raw accumulators [tile][8][128
// threads].
constexpr int kKBlock = 64 * 128;
__host__ __device__ constexpr int layer_base(int l) {  // l = 1..5
  return kKBlock * (l - 1) * l / 2;
}
constexpr int kHeadBase = layer_base(5);
constexpr int kVecBase = kHeadBase + 5 * kKBlock;

template <int NF>
__host__ __device__ constexpr int acc_base() {
  return kVecBase + (5 * NF / 2) * 4 + (4 * NF + kHeadRows) * 4 +
         kMaxModes * 16 * 4;
}

template <int NF, int SRC>
constexpr size_t smem_bytes() {
  return (size_t)acc_base<NF>() + (SRC == kUnit ? 0 : kBlockSites * 16 * 4) +
         1024;  // room to align the base
}

// rows x K bf16 into swizzled K-blocks at dst.  Row r's chunk c (8 bf16)
// is read from src + r*ld + 8c; PAIRED, from the diagonal block of a
// pair_stage_params layer: block j = c / (NF/8) at column 2NF*j, plus
// `odd` for rows of odd rotations (row / 16 odd; the output head's
// B-rotation blocks).  The off-diagonal blocks are exact zeros and are
// never read.
template <int NF, bool PAIRED>
__device__ __forceinline__ void stage(unsigned char* dst,
                                      const __nv_bfloat16* src, int rows,
                                      int K, int ld, int odd) {
  constexpr int per_block = NF / 8;
  const int chunks = K / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += kDenseThreads) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    const int col = PAIRED ? (c / per_block) * 2 * NF +
                                 8 * (c % per_block) + ((r >> 4) & 1) * odd
                           : 8 * c;
    *reinterpret_cast<int4*>(dst + sw128(r, c, kKBlock)) =
        __ldg(reinterpret_cast<const int4*>(src + (long long)r * ld + col));
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

// Mode mi's weights into shared memory (layout above).  The caller's
// __syncthreads() after it, with each thread's proxy fence here, orders
// the stores before any warpgroup's wgmma reads them.
template <int NF, bool PAIRED>
__device__ __forceinline__ void stage_mode(const DenseParams& p, int mi,
                                           unsigned char* sm, int head_rows) {
  constexpr int kPair = PAIRED ? 2 : 1;
#pragma unroll
  for (int l = 1; l <= 4; ++l)
    stage<NF, PAIRED>(sm + layer_base(l),
                      p.wt[l - 1] + (long long)mi * kPair * kPair * NF * l * NF,
                      NF, l * NF, kPair * l * NF, 0);
  stage<NF, PAIRED>(sm + kHeadBase,
                    p.w6t + (long long)mi * head_rows * kPair * 5 * NF,
                    head_rows, 5 * NF, kPair * 5 * NF, NF);
  uint32_t* sW1 = reinterpret_cast<uint32_t*>(sm + kVecBase);
  uint32_t* sB1 = sW1 + 4 * NF / 2;
  float* sHB = reinterpret_cast<float*>(sB1 + NF / 2);
  float* sB6 = sHB + 4 * NF;
  const __nv_bfloat16* w1 = p.w1t + (long long)mi * NF * 4;
  for (int i = threadIdx.x; i < 4 * NF / 2; i += kDenseThreads) {
    const int k = i / (NF / 2), f = 2 * (i % (NF / 2));  // i = k*NF/2 + f/2
    sW1[i] = bits(w1[f * 4 + k]) | bits(w1[(f + 1) * 4 + k]) << 16;
  }
  for (int i = threadIdx.x; i < NF; i += kDenseThreads) {
    if (i % 2 == 0)
      sB1[i / 2] = bits(p.b1[mi * NF + i]) | bits(p.b1[mi * NF + i + 1]) << 16;
#pragma unroll
    for (int l = 0; l < 4; ++l)
      sHB[l * NF + i] = __bfloat162float(p.hb[l][mi * kPair * NF + i]);
  }
  for (int i = threadIdx.x; i < head_rows; i += kDenseThreads)
    sB6[i] = __bfloat162float(p.b6[mi * head_rows + i]);
  fence_async_shared();  // the stores above, before wgmma reads them
}

// The 4 taps of site s for pass column block col, each as a bf16 in both
// halves of a word; 0 for a site past n and, on the plane, for a tap
// outside [0, n) (the TPU's zero-padded windows).
template <int SRC>
__device__ __forceinline__ void load_taps2(const DenseParams& p,
                                           const int* sOff, long long s,
                                           int col, uint32_t (&tb)[4]) {
  if (SRC == kSite || SRC == kUnit) {
    uint2 raw = make_uint2(0u, 0u);
    if (s < p.n)
      raw = *reinterpret_cast<const uint2*>(
          p.taps + (SRC == kUnit ? s * 4 : s * 16 * p.modes + col));
    tb[0] = __byte_perm(raw.x, 0, 0x1010);
    tb[1] = __byte_perm(raw.x, 0, 0x3232);
    tb[2] = __byte_perm(raw.y, 0, 0x1010);
    tb[3] = __byte_perm(raw.y, 0, 0x3232);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long q = SRC == kFeature ? s : s + sOff[col + k];
    uint32_t b = 0u;
    if (s < p.n && q >= 0 && q < p.n)
      b = bits(p.taps[SRC == kFeature ? (col + k) * p.n + q : q]);
    tb[k] = b | b << 16;
  }
}

// The head of sites s_lo and s_lo + 8 for pass (mi, r) into the A
// fragments of the first concat slot, a[0 .. NF/16): features 2q, 2q+1
// of a site in one bf16x2 chain.
template <int NF, int SRC>
__device__ __forceinline__ void head_slot(const DenseParams& p,
                                          const int* sOff,
                                          const uint32_t* sW1,
                                          const uint32_t* sB1, long long s_lo,
                                          int mi, int r, int t,
                                          uint32_t (&a)[5 * NF / 16][4]) {
  const int col = (mi * 4 + r) * 4;
  uint32_t tl[4], th[4];
  load_taps2<SRC>(p, sOff, s_lo, col, tl);
  load_taps2<SRC>(p, sOff, s_lo + 8, col, th);
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

// Concat layers 2..5 of the warpgroup's tile: layer l+1 reads a[0 ..
// l*NF/16) and its bf16 ReLU output fills a[l*NF/16 .. (l+1)*NF/16).
// desc: the descriptor of the staged weights' base (an offset of o bytes
// is desc + o/16: every address stays below 2^18).
template <int NF>
__device__ __forceinline__ void concat_layers(uint32_t (&a)[5 * NF / 16][4],
                                              uint64_t desc, const float* sHB,
                                              int t) {
  constexpr int KT1 = NF / 16;
#pragma unroll
  for (int l = 1; l <= 4; ++l) {
    float c[NF / 2];
#pragma unroll
    for (int i = 0; i < NF / 2; ++i) c[i] = 0.f;
    fence_operands(c);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < l * KT1; ++kt)
      wgmma_n64(c, a[kt], desc + ((layer_base(l) + (kt >> 2) * kKBlock +
                                   (kt & 3) * 32) >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(c);
    const float* hb = sHB + (l - 1) * NF;
#pragma unroll
    for (int nt = 0; nt < NF / 8; ++nt) {
      const float2 b = *reinterpret_cast<const float2*>(hb + nt * 8 + 2 * t);
      const int kt = l * KT1 + nt / 2;
      a[kt][(nt & 1) * 2] = pack_relu(c[4 * nt] + b.x, c[4 * nt + 1] + b.y);
      a[kt][(nt & 1) * 2 + 1] =
          pack_relu(c[4 * nt + 2] + b.x, c[4 * nt + 3] + b.y);
    }
  }
}

// The output head before its bias: NT n8 tiles (1 or 2) of the head rows
// whose descriptor is `rows`, over the whole concat.
template <int NF, int NT>
__device__ __forceinline__ void head_product(
    float (&c)[4 * NT], const uint32_t (&a)[5 * NF / 16][4], uint64_t rows) {
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) c[i] = 0.f;
  fence_operands(c);
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < 5 * NF / 16; ++kt) {
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
// (acc[nt][i]: site s_lo for i < 2 else s_lo + 8, lane nt*8 + 2t + (i&1)).
template <int NF, int NT>
__device__ __forceinline__ void accumulate(float (&acc)[2][4],
                                           const uint32_t (&a)[5 * NF / 16][4],
                                           uint64_t rows, const float* b6,
                                           int t) {
  float c[4 * NT];
  head_product<NF, NT>(c, a, rows);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float o = tanhf(c[4 * nt + i] + b6[nt * 8 + 2 * t + (i & 1)]);
      acc[nt][i] += rintf(__fmul_rn(o, 127.f));
    }
  }
}

// K10: the block's share of the 64-row tiles (tile j by warpgroup j mod
// kGroups of block (j / kGroups) mod gridDim), each row's NT*8 head
// columns out as bf16(tanh(.)).
template <int NF, int NT>
__device__ __forceinline__ void unit_tiles(const DenseParams& p,
                                           const uint32_t* sW1,
                                           const uint32_t* sB1,
                                           const float* sHB, const float* sB6,
                                           uint64_t desc, int group, int row0,
                                           int t) {
  const long long tiles = (p.n + kTile - 1) / kTile;
#pragma unroll 1
  for (long long j = (long long)blockIdx.x * kGroups + group; j < tiles;
       j += (long long)gridDim.x * kGroups) {
    const long long s_lo = j * kTile + row0;
    uint32_t a[5 * NF / 16][4];
    head_slot<NF, kUnit>(p, nullptr, sW1, sB1, s_lo, 0, 0, t, a);
    concat_layers<NF>(a, desc, sHB, t);
    float c[4 * NT];
    head_product<NF, NT>(c, a, desc + (kHeadBase >> 4));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long s = s_lo + 8 * h;
        const int col = nt * 8 + 2 * t;
        if (s < p.n)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.out) + s * p.v + col) =
              __floats2bfloat162_rn(tanhf(c[4 * nt + 2 * h] + sB6[col]),
                                    tanhf(c[4 * nt + 2 * h + 1] + sB6[col + 1]));
      }
    }
  }
}

// One block per SM (124-172 KB of shared memory), so the minimum of 1
// block lets ptxas give each of the 384 threads up to 168 registers for
// the concat fragments, a layer's accumulator and the addressing.
template <int NF, int SRC, int MIX, bool PAIRED>
__global__ void __launch_bounds__(kDenseThreads, 1)
dense_kernel(const DenseParams p) {
  static_assert(NF == 64, "the layout takes 64-column K-blocks and n64");
  constexpr int KH = 5 * NF / 16;  // k-tiles of the whole concat
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint64_t desc = sw128_desc(smem_u32(sm));
  const uint32_t* sW1 = reinterpret_cast<const uint32_t*>(sm + kVecBase);
  const uint32_t* sB1 = sW1 + 4 * NF / 2;
  const float* sHB = reinterpret_cast<const float*>(sB1 + NF / 2);
  const float* sB6 = sHB + 4 * NF;
  int* sOff = reinterpret_cast<int*>(sm + acc_base<NF>()) - kMaxModes * 16;
  float* sAcc = reinterpret_cast<float*>(sm + acc_base<NF>());

  const int group = threadIdx.x >> 7;
  const int wt = threadIdx.x & 127;  // thread in the warpgroup
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = (wt >> 5) * 16 + g;  // the warp's 16 rows of the tile
  const bool wide = p.v > 8;            // two n8 tiles of output lanes
  // a single unit's head has v (8 or 16) rows; an ensemble's 4 x 16
  const int head_rows = SRC == kUnit ? p.v : kHeadRows;

  if (SRC == kPlane) {
    for (int i = threadIdx.x; i < p.modes * 16; i += kDenseThreads)
      sOff[i] = p.offs[i];
  }

  if (SRC == kUnit) {  // K10: persistent blocks over 64-row tiles
    stage_mode<NF, false>(p, 0, sm, head_rows);
    __syncthreads();
    if (wide)
      unit_tiles<NF, 2>(p, sW1, sB1, sHB, sB6, desc, group, row0, t);
    else
      unit_tiles<NF, 1>(p, sW1, sB1, sHB, sB6, desc, group, row0, t);
    return;
  }

  const long long block0 = (long long)blockIdx.x * kBlockSites;
  for (int mi = 0; mi < p.modes; ++mi) {
    __syncthreads();  // the previous mode's weights are no longer read
    stage_mode<NF, PAIRED>(p, mi, sm, head_rows);
    __syncthreads();
#pragma unroll 1
    for (int j = group; j < kBlockTiles; j += kGroups) {
      const long long s_lo = block0 + j * kTile + row0;
      if (block0 + j * kTile >= p.n) break;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 1
      for (int r = 0; r < 4; ++r) {
        uint32_t a[KH][4];
        head_slot<NF, SRC>(p, sOff, sW1, sB1, s_lo, mi, r, t, a);
        concat_layers<NF>(a, desc, sHB, t);
        const uint64_t rows = desc + ((kHeadBase + r * 16 * 128) >> 4);
        if (wide)
          accumulate<NF, 2>(acc, a, rows, sB6 + 16 * r, t);
        else
          accumulate<NF, 1>(acc, a, rows, sB6 + 16 * r, t);
      }
      // the raw accumulator across modes: thread-private slots, so the
      // same thread reads back what it wrote (integer sums, exact)
      float* slot = sAcc + j * 8 * 128 + wt;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (mi > 0) acc[i >> 2][i & 3] += slot[i * 128];
        if (mi + 1 < p.modes) slot[i * 128] = acc[i >> 2][i & 3];
      }
      if (mi + 1 < p.modes) continue;
      if (MIX == kSiteAcc)
        store_mix<kNone, true>(acc, p.out, p.n, s_lo, s_lo + 8, t, p.modes,
                               p.inv_4m);
      else
        store_mix<MIX>(acc, p.out, p.n, s_lo, s_lo + 8, t, p.modes, p.inv_4m);
    }
  }
}

template <int NF, int SRC, int MIX, bool PAIRED>
int launch(const DenseParams& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NF, SRC>();
  auto kern = dense_kernel<NF, SRC, MIX, PAIRED>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (p.n + kBlockSites - 1) / kBlockSites;
  if (SRC == kUnit) {  // persistent: at most one block per SM
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const long long tiles = (p.n + kTile - 1) / kTile;
    blocks = (tiles + kGroups - 1) / kGroups;
    if (blocks > sms) blocks = sms;
  }
  kern<<<(unsigned)blocks, kDenseThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The stage-mix instance of a feature-major route (K5, K7).
template <int NF, int SRC>
int launch_mix(const DenseParams& p, int mix, cudaStream_t s) {
  switch (mix) {
    case kNone: return launch<NF, SRC, kNone, false>(p, s);
    case kInner: return launch<NF, SRC, kInner, false>(p, s);
    case kFinal: return launch<NF, SRC, kFinal, false>(p, s);
    case kFinalU8: return launch<NF, SRC, kFinalU8, false>(p, s);
    case kFinalPack: return launch<NF, SRC, kFinalPack, false>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Checks shared by the entry points; 0 when p may be launched.
inline int check_params(const DenseParams* p) {
  if (p->modes < 1 || p->modes > kMaxModes || p->v < 1 || p->v > 16 ||
      p->n > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

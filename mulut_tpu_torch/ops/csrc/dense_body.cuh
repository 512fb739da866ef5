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
// mode's staging is not overlapped with its first tiles.  The weight
// tiles are copied with cp.async (all of a thread's copies in flight at
// once), the vectors with ordinary stores, and wgmma reads them through
// the async proxy, so each staging ends with cp.async.wait_all and a
// proxy fence (stage_wait) before the block's barrier; the ensembles
// restage the same bytes for every mode, and without the fence a wgmma
// could read the last mode's.
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

// Launch geometry (chip_smoke.dense_grid and friends are its Python copy).
constexpr int kGroups = 3;                      // warpgroups per block
constexpr int kDenseThreads = 128 * kGroups;
constexpr int kTile = 64;                       // sites per warpgroup tile
constexpr int kBlockSites = 768;                // sites per ensemble block

// Shared layout from a 1024-byte-aligned base: concat layer l = 1..4
// (slot l <- layer l+1) as l swizzled K-blocks of 64 rows x 64 columns,
// the output head as 5 K-blocks of 64 rows (a unit's v rows use the first
// v), then w1 as bf16 feature pairs [4][nf/2] and b1 as pairs [nf/2]
// (32-bit words), float hidden biases [4][nf] and b6 [64], the plane
// offsets, and for the ensembles the raw accumulators [tile][8][128
// threads].
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
  stage_sw128<kDenseThreads>(dst, src, rows, K, ld, kKBlock,
                             [=](int r, int c) {
    return PAIRED ? (c / per_block) * 2 * NF + 8 * (c % per_block) +
                        ((r >> 4) & 1) * odd
                  : 8 * c;
  });
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
  stage_head_pairs<kDenseThreads, NF>(
      sW1, sB1, p.w1t + (long long)mi * NF * 4, p.b1 + mi * NF);
  for (int i = threadIdx.x; i < NF; i += kDenseThreads) {
#pragma unroll
    for (int l = 0; l < 4; ++l)
      sHB[l * NF + i] = __bfloat162float(p.hb[l][mi * kPair * NF + i]);
  }
  for (int i = threadIdx.x; i < head_rows; i += kDenseThreads)
    sB6[i] = __bfloat162float(p.b6[mi * head_rows + i]);
  stage_wait();  // the copies and stores above, before wgmma reads them
}

// The head of sites s_lo and s_lo + 8 for pass (mi, r) into the A
// fragments of the first concat slot, a[0 .. NF/16).
template <int NF, int SRC>
__device__ __forceinline__ void head_slot(const DenseParams& p,
                                          const int* sOff,
                                          const uint32_t* sW1,
                                          const uint32_t* sB1, long long s_lo,
                                          int mi, int r, int t,
                                          uint32_t (&a)[5 * NF / 16][4]) {
  const int col = (mi * 4 + r) * 4;
  uint32_t tl[4], th[4];
  load_taps2<SRC>(p.taps, p.n, p.modes, sOff, s_lo, col, tl);
  load_taps2<SRC>(p.taps, p.n, p.modes, sOff, s_lo + 8, col, th);
  bf16x2_head<NF>(sW1, sB1, tl, th, t, a);
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
    pack_layer<NF / 8>(c, sHB + (l - 1) * NF, t, a, l * KT1);
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
    head_product<5 * NF / 16, NT>(c, a, desc + (kHeadBase >> 4));
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
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // the warp's 16 rows of the tile
  const int row0 = ((threadIdx.x & 127) >> 5) * 16 + g;
  const bool wide = p.v > 8;            // two n8 tiles of output lanes
  // a single unit's head has v (8 or 16) rows; an ensemble's 4 x 16
  const int head_rows = SRC == kUnit ? p.v : kHeadRows;

  if (SRC == kPlane) stage_offsets<kDenseThreads>(sOff, p.offs, p.modes);

  if (SRC == kUnit) {  // K10: persistent blocks over 64-row tiles
    stage_mode<NF, false>(p, 0, sm, head_rows);
    __syncthreads();
    if (wide)
      unit_tiles<NF, 2>(p, sW1, sB1, sHB, sB6, desc, group, row0, t);
    else
      unit_tiles<NF, 1>(p, sW1, sB1, sHB, sB6, desc, group, row0, t);
    return;
  }

  ensemble_block<kGroups, kTile, kBlockSites>(
      p.n, p.modes, sAcc, row0,
      [&](int mi) { stage_mode<NF, PAIRED>(p, mi, sm, head_rows); },
      [&](float (&acc)[2][4], long long s_lo, int mi, int r) {
        uint32_t a[KH][4];
        head_slot<NF, SRC>(p, sOff, sW1, sB1, s_lo, mi, r, t, a);
        concat_layers<NF>(a, desc, sHB, t);
        const uint64_t rows = desc + ((kHeadBase + r * 16 * 128) >> 4);
        if (wide)
          accumulate<KH, 2>(acc, a, rows, sB6 + 16 * r, t);
        else
          accumulate<KH, 1>(acc, a, rows, sB6 + 16 * r, t);
      },
      [&](const float (&acc)[2][4], long long s_lo) {
        if (MIX == kSiteAcc)
          store_mix<kNone, true>(acc, p.out, p.n, s_lo, s_lo + 8, t,
                                 p.modes, p.inv_4m);
        else
          store_mix<MIX>(acc, p.out, p.n, s_lo, s_lo + 8, t, p.modes,
                         p.inv_4m);
      });
}

template <int NF, int SRC, int MIX, bool PAIRED>
int launch(const DenseParams& p, cudaStream_t stream) {
  long long blocks = (p.n + kBlockSites - 1) / kBlockSites;
  if (SRC == kUnit) {  // persistent: at most one block per SM
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const long long tiles = (p.n + kTile - 1) / kTile;
    blocks = (tiles + kGroups - 1) / kGroups;
    if (blocks > sms) blocks = sms;
  }
  return launch_kernel(dense_kernel<NF, SRC, MIX, PAIRED>, p, blocks,
                       kDenseThreads, smem_bytes<NF, SRC>(), stream);
}

// The stage-mix instance of a feature-major route (K5, K7).
template <int NF, int SRC>
int launch_mix(const DenseParams& p, int mix, cudaStream_t s) {
  return dispatch_mix<true>(mix, [&](auto m) {
    return launch<NF, SRC, decltype(m)::value, false>(p, s);
  });
}

// Checks shared by the entry points; 0 when p may be launched.
inline int check_params(const DenseParams* p) {
  return check_ensemble(p->modes, p->v, p->n);
}

}  // namespace

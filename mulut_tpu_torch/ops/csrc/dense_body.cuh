// The dense-concat unit pass, sm_90a: one body for every dense-unit kernel
// of net mode (K4, K5, K7, K9 in dense_ensemble.cu, dense_window.cu,
// dense_feature.cu; K10 in dense_unit.cu).  For every site n and pass
// (mode m, rotation r), with t its 4 bf16 taps:
//
//   c1 = relu(bf16 chain: sum_k bf16(t[k] * w1[m][k]), then + b1[m])
//   c_l = bf16(relu([c1 .. c_(l-1)] . w_(l+1)[m] + b_(l+1)[m])),  l = 2..5
//   acc[n][j] += rint(127 * tanh([c1 .. c5] . w6[m][:, 16r + j] + b6[..]))
//
// The head is the TPU kernels' broadcast form (net_common.cuh's
// chain_head): every product and every running sum is rounded to bf16, in
// tap order, then + b1 in bf16, then ReLU, so it is bit-identical to the
// JAX kernels.  The concat layers and the output head are bf16 products
// summed in float32; tanh and rounding (half to even) are float32.  Build
// without --use_fast_math.
//
// Bound: operations.  Per site and pass the concat layers are
// 2*nf^2*(1+2+3+4) flops (81,920 at nf=64) and the output head 2*5nf*v,
// against at most 96 bytes of taps per site for all 12 passes.  Design: a
// block owns 128 consecutive sites, one warp 16 of them; all products
// after the head are warp-level tensor-core MMAs (mma.sync m16n8k16, bf16
// in, f32 accumulate).  The whole (16, 5nf) concat lives in the warp's
// registers as A fragments: each layer's f32 output fragment, packed to
// bf16, is the A fragment of the next k-tiles, so no activation touches
// shared or device memory.  The mode's weights (w2..w5 and w6, transposed
// so each output column's K values are contiguous; 128 KB at nf=64) are
// staged in shared memory once per mode and read by all 4 rotations, with
// rows padded by 8 bf16 for conflict-free fragment loads.  The inner stage
// (v = 1) computes only the first 8 output lanes; the rest are zero
// padding and stay 0.
//
// Template parameters pick where the taps come from (SRC), how the
// accumulator leaves (MIX) and how the weights are laid out (PAIRED);
// everything from the staged weights on is the same code for all of them,
// so K5, K7 and K9 return K4's accumulator bit for bit.

#pragma once

#include "net_common.cuh"

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

// bf16 head of feature f (net_common.cuh's chain): w1 is [k][f] (float
// copies of bf16 values).
template <int NF>
__device__ __forceinline__ float head(const float* w1, const float* b1, int f,
                                      const float (&t)[4]) {
  return chain_head(w1 + f, NF, b1[f], t);
}

// The diagonal blocks of a rotation-paired layer into the unpaired shared
// layout: row r of nb blocks of NF bf16 (shared row stride ld, block j at
// column j*NF) is read from src + r*src_ld + j*2NF, plus `odd` for rows
// of odd rotations (row / 16 odd; the output head's B-rotation blocks).
// The off-diagonal blocks are exact zeros and are never read.
template <int NF>
__device__ __forceinline__ void copy_pair_blocks(__nv_bfloat16* dst, int ld,
                                                 const __nv_bfloat16* src,
                                                 int rows, int nb, int src_ld,
                                                 int odd) {
  constexpr int chunks = NF / 8;
  const int per_row = nb * chunks;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int j = (i - r * per_row) / chunks;
    const int c = i - r * per_row - j * chunks;
    *reinterpret_cast<int4*>(dst + r * ld + j * NF + 8 * c) =
        __ldg(reinterpret_cast<const int4*>(
            src + (long long)r * src_ld + j * 2 * NF + ((r >> 4) & 1) * odd +
            8 * c));
  }
}

// Shared layout: concat layers l = 2..5 (nf rows of (l-1)*nf + 8), then
// the output head (64 rows of 5nf + 8), then float w1 [4][nf], b1 [nf],
// hidden biases [4][nf] and b6 [64].
template <int NF>
__host__ __device__ constexpr int layer_offset(int l) {  // l = 1..4
  return NF * ((l - 1) * NF * l / 2 + 8 * (l - 1));
}

template <int NF>
constexpr size_t smem_bytes() {
  return (size_t)(layer_offset<NF>(5) + kHeadRows * (5 * NF + 8)) * 2 +
         (size_t)(4 * NF + NF + 4 * NF + kHeadRows) * 4;
}

// One block per SM (the staged weights take ~128 KB of shared memory), so
// the minimum of 1 block lets ptxas give the concat fragments the
// registers they need: without it, it capped most instances at 128
// registers and spilled, which made K4 slower on the card.
template <int NF, int SRC, int MIX, bool PAIRED>
__global__ void __launch_bounds__(kThreads, 1)
dense_kernel(const DenseParams p) {
  constexpr int KT1 = NF / 16;  // k-tiles of one concat slot
  constexpr int NT = NF / 8;    // n-tiles of one layer's output
  constexpr int KH = 5 * KT1;   // k-tiles of the whole concat
  constexpr int LD6 = 5 * NF + 8;
  constexpr int kRots = SRC == kUnit ? 1 : 4;
  constexpr int kPair = PAIRED ? 2 : 1;  // width factor of paired weights
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sW6 = sW + layer_offset<NF>(5);
  float* sW1 = reinterpret_cast<float*>(sW6 + kHeadRows * LD6);
  float* sB1 = sW1 + 4 * NF;
  float* sHB = sB1 + NF;
  float* sB6 = sHB + 4 * NF;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long s_lo = (long long)blockIdx.x * kSites + warp * 16 + g;
  const long long s_hi = s_lo + 8;
  const int stride = 16 * p.modes;
  const int out_tiles = p.v > 8 ? 2 : 1;
  // a single unit's head has v (8 or 16) rows; an ensemble's 4 x 16
  const int head_rows = SRC == kUnit ? p.v : kHeadRows;

  __shared__ int sOff[SRC == kPlane ? kMaxModes * 16 : 1];
  if (SRC == kPlane) {
    for (int i = threadIdx.x; i < p.modes * 16; i += kThreads)
      sOff[i] = p.offs[i];
  }
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int mi = 0; mi < p.modes; ++mi) {
    __syncthreads();  // the previous mode's weights are no longer read
    if (PAIRED) {
#pragma unroll
      for (int l = 1; l <= 4; ++l)
        copy_pair_blocks<NF>(sW + layer_offset<NF>(l), l * NF + 8,
                             p.wt[l - 1] + (long long)mi * 4 * NF * l * NF,
                             NF, l, 2 * l * NF, 0);
      copy_pair_blocks<NF>(sW6, LD6, p.w6t + (long long)mi * kHeadRows * 10 * NF,
                           kHeadRows, 5, 10 * NF, NF);
    } else {
#pragma unroll
      for (int l = 1; l <= 4; ++l)
        copy_rows(sW + layer_offset<NF>(l), l * NF + 8,
                  p.wt[l - 1] + (long long)mi * NF * l * NF, NF, l * NF);
      copy_rows(sW6, LD6, p.w6t + (long long)mi * head_rows * 5 * NF,
                head_rows, 5 * NF);
    }
    for (int i = threadIdx.x; i < 4 * NF; i += kThreads)  // i = k*NF + f
      sW1[i] = __bfloat162float(
          p.w1t[(long long)mi * 4 * NF + (i % NF) * 4 + i / NF]);
    for (int i = threadIdx.x; i < NF; i += kThreads) {
      sB1[i] = __bfloat162float(p.b1[mi * NF + i]);
#pragma unroll
      for (int l = 0; l < 4; ++l)
        sHB[l * NF + i] = __bfloat162float(p.hb[l][mi * kPair * NF + i]);
    }
    for (int i = threadIdx.x; i < head_rows; i += kThreads)
      sB6[i] = __bfloat162float(p.b6[mi * head_rows + i]);
    __syncthreads();

    for (int r = 0; r < kRots; ++r) {
      const int col = (mi * 4 + r) * 4;
      float tl[4], th[4];
      if (SRC == kSite) {
        load_taps(p.taps, s_lo, p.n, stride, col, tl);
        load_taps(p.taps, s_hi, p.n, stride, col, th);
      } else if (SRC == kUnit) {
        load_taps(p.taps, s_lo, p.n, 4, 0, tl);
        load_taps(p.taps, s_hi, p.n, 4, 0, th);
      } else if (SRC == kFeature) {
        load_taps_t(p.taps, s_lo, p.n, col, tl);
        load_taps_t(p.taps, s_hi, p.n, col, th);
      } else {
        const int* off = sOff + col;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          tl[k] = tap(p.taps, p.n, s_lo + off[k]);
          th[k] = tap(p.taps, p.n, s_hi + off[k]);
        }
      }
      uint32_t a[KH][4];
#pragma unroll
      for (int kt = 0; kt < KT1; ++kt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 16 * kt + 8 * h + 2 * t;
          a[kt][2 * h] = pack_bf16(head<NF>(sW1, sB1, f, tl),
                                   head<NF>(sW1, sB1, f + 1, tl));
          a[kt][2 * h + 1] = pack_bf16(head<NF>(sW1, sB1, f, th),
                                       head<NF>(sW1, sB1, f + 1, th));
        }
      }
#pragma unroll
      for (int l = 1; l <= 4; ++l) {  // concat slot l <- layer l+1
        const __nv_bfloat16* w = sW + layer_offset<NF>(l);
        const int ld = l * NF + 8;
        float c[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < l * KT1; ++kt) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const __nv_bfloat16* wr = w + (nt * 8 + g) * ld + kt * 16 + 2 * t;
            mma_bf16(c[nt], a[kt], ld_b32(wr), ld_b32(wr + 8));
          }
        }
        const float* hb = sHB + (l - 1) * NF;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int cc = nt * 8 + 2 * t;
          const float b0 = hb[cc], b1 = hb[cc + 1];
          const int kt = l * KT1 + nt / 2;
          a[kt][(nt & 1) * 2] = pack_bf16(fmaxf(c[nt][0] + b0, 0.f),
                                          fmaxf(c[nt][1] + b1, 0.f));
          a[kt][(nt & 1) * 2 + 1] = pack_bf16(fmaxf(c[nt][2] + b0, 0.f),
                                              fmaxf(c[nt][3] + b1, 0.f));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (nt >= out_tiles) break;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kt = 0; kt < KH; ++kt) {
          const __nv_bfloat16* wr =
              sW6 + (r * 16 + nt * 8 + g) * LD6 + kt * 16 + 2 * t;
          mma_bf16(c, a[kt], ld_b32(wr), ld_b32(wr + 8));
        }
        if (SRC == kUnit) {  // K10: bf16(tanh) of each output column
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long s = h ? s_hi : s_lo;
            const int j = nt * 8 + 2 * t;
            if (s < p.n)
              *reinterpret_cast<__nv_bfloat162*>(
                  static_cast<__nv_bfloat16*>(p.out) + s * p.v + j) =
                  __floats2bfloat162_rn(tanhf(c[2 * h] + sB6[j]),
                                        tanhf(c[2 * h + 1] + sB6[j + 1]));
          }
          continue;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float o = tanhf(c[i] + sB6[r * 16 + nt * 8 + 2 * t + (i & 1)]);
          acc[nt][i] += rintf(__fmul_rn(o, 127.f));
        }
      }
    }
  }

  if (SRC == kUnit) return;
  if (MIX == kSiteAcc)
    store_mix<kNone, true>(acc, p.out, p.n, s_lo, s_hi, t, p.modes, p.inv_4m);
  else
    store_mix<MIX>(acc, p.out, p.n, s_lo, s_hi, t, p.modes, p.inv_4m);
}

template <int NF, int SRC, int MIX, bool PAIRED>
int launch(const DenseParams& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NF>();
  auto kern = dense_kernel<NF, SRC, MIX, PAIRED>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (p.n + kSites - 1) / kSites;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
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

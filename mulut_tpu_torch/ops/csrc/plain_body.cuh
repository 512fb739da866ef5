// The plain-unit pass, sm_90a: one body for every bf16 kernel of plain
// (mxu-arch) units in net mode (K3 in plain_window.cu, K6 in
// plain_feature.cu, K8 in plain_site.cu).  For every site p and every pass
// (mode m, rotation r), with x0 its 4 taps:
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
// IEEE.  The head above is the float32 dot (the JAX package's "mxu" head);
// K8 may take the bf16 broadcast chain instead (PLAIN_HEAD = "vpu",
// net_common.cuh's chain_head), a different function.
//
// Bound: operations.  Per site and pass the hidden layers are 2*nf^2*D
// flops (65,536 at nf=128, D=2) against 2 bytes of input; the tensor cores
// bound it.  Design: a block owns 128 consecutive sites, one warp 16 of
// them.  The hidden and output layers are warp-level tensor-core MMAs
// (mma.sync m16n8k16, bf16 in, f32 accumulate).  A layer's f32 output
// fragment is exactly the next layer's A fragment once packed to bf16, so
// each warp's activations (16 sites x nf) never leave its registers, and
// the layers of a warp need no block synchronisation.  The mode's weights
// (D * nf * nf + 64 * nf bf16, 87 KB at nf=128, D=2) are staged in shared
// memory once per mode and read by all 4 rotations; rows are padded by 8
// bf16 so the B-fragment loads are free of bank conflicts.  The head
// (K = 4) runs on the CUDA cores in float32.  The inner stage's output head
// computes only its first 8 lanes (v = 1; the other lanes are zero
// padding).
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

// float32 head of feature f: w1 is [f][k] (float copies of bf16 values).
__device__ __forceinline__ float head_f32(const float* w1, const float* b1,
                                          int f, const float (&t)[4]) {
  const float* w = w1 + 4 * f;
  float s = t[0] * w[0];
  s = s + t[1] * w[1];
  s = s + t[2] * w[2];
  s = s + t[3] * w[3];
  return fmaxf(s + b1[f], 0.f);
}

template <int HEAD>
__device__ __forceinline__ float head(const float* w1, const float* b1, int f,
                                      const float (&t)[4]) {
  if (HEAD == kHeadBf16) return chain_head(w1 + 4 * f, 1, b1[f], t);
  return head_f32(w1, b1, f, t);
}

template <int NF>
constexpr size_t smem_bytes(int depth) {
  return (size_t)(depth * NF + kHeadRows) * (NF + 8) * 2 +
         (size_t)(NF * 4 + NF + depth * NF + kHeadRows) * 4;
}

template <int NF, int SRC, int MIX, int HEAD>
__global__ void __launch_bounds__(kThreads)
plain_kernel(const PlainParams p) {
  constexpr int KT = NF / 16;  // k-tiles of an activation
  constexpr int NT = NF / 8;   // n-tiles of a hidden layer's output
  constexpr int LD = NF + 8;   // padded shared row (bf16)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sW6 = sW + p.depth * NF * LD;
  float* sW1 = reinterpret_cast<float*>(sW6 + kHeadRows * LD);  // [f][k]
  float* sB1 = sW1 + NF * 4;
  float* sHB = sB1 + NF;
  float* sB6 = sHB + p.depth * NF;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const long long s_lo = (long long)blockIdx.x * kSites + warp * 16 + g;
  const long long s_hi = s_lo + 8;
  const int out_tiles = p.v > 8 ? 2 : 1;

  __shared__ int sOff[SRC == kPlane ? kMaxModes * 16 : 1];
  if (SRC == kPlane) {
    for (int i = threadIdx.x; i < p.modes * 16; i += kThreads)
      sOff[i] = p.offs[i];
  }
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int mi = 0; mi < p.modes; ++mi) {
    __syncthreads();  // the previous mode's weights are no longer read
    for (int d = 0; d < p.depth; ++d)
      copy_rows(sW + d * NF * LD, LD,
                p.hwt + ((long long)d * p.modes + mi) * NF * NF, NF, NF);
    copy_rows(sW6, LD, p.w6t + (long long)mi * kHeadRows * NF, kHeadRows, NF);
    for (int i = threadIdx.x; i < NF * 4; i += kThreads)
      sW1[i] = __bfloat162float(p.w1t[(long long)mi * NF * 4 + i]);
    for (int i = threadIdx.x; i < NF; i += kThreads)
      sB1[i] = __bfloat162float(p.b1[mi * NF + i]);
    for (int i = threadIdx.x; i < p.depth * NF; i += kThreads) {
      const int d = i / NF;
      sHB[i] = __bfloat162float(
          p.hb[((long long)d * p.modes + mi) * NF + (i - d * NF)]);
    }
    for (int i = threadIdx.x; i < kHeadRows; i += kThreads)
      sB6[i] = __bfloat162float(p.b6[mi * kHeadRows + i]);
    __syncthreads();

    for (int r = 0; r < 4; ++r) {
      const int col = (mi * 4 + r) * 4;
      float tl[4], th[4];
      if (SRC == kSite) {
        load_taps(p.taps, s_lo, p.n, 16 * p.modes, col, tl);
        load_taps(p.taps, s_hi, p.n, 16 * p.modes, col, th);
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
      // head -> A fragments: a[kt] covers features 16kt .. 16kt+15
      uint32_t a[KT][4];
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 16 * kt + 8 * h + 2 * t;
          a[kt][2 * h] = pack_bf16(head<HEAD>(sW1, sB1, f, tl),
                                   head<HEAD>(sW1, sB1, f + 1, tl));
          a[kt][2 * h + 1] = pack_bf16(head<HEAD>(sW1, sB1, f, th),
                                       head<HEAD>(sW1, sB1, f + 1, th));
        }
      }
      for (int d = 0; d < p.depth; ++d) {
        const __nv_bfloat16* w = sW + d * NF * LD;
        float c[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const __nv_bfloat16* wr = w + (nt * 8 + g) * LD + kt * 16 + 2 * t;
            mma_bf16(c[nt], a[kt], ld_b32(wr), ld_b32(wr + 8));
          }
        }
        const float* hb = sHB + d * NF;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int cc = nt * 8 + 2 * t;
          const float b0 = hb[cc], b1 = hb[cc + 1];
          a[nt / 2][(nt & 1) * 2] = pack_bf16(fmaxf(c[nt][0] + b0, 0.f),
                                              fmaxf(c[nt][1] + b1, 0.f));
          a[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(fmaxf(c[nt][2] + b0, 0.f),
                                                  fmaxf(c[nt][3] + b1, 0.f));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (nt >= out_tiles) break;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          const __nv_bfloat16* wr =
              sW6 + (r * 16 + nt * 8 + g) * LD + kt * 16 + 2 * t;
          mma_bf16(c, a[kt], ld_b32(wr), ld_b32(wr + 8));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float o = tanhf(c[i] + sB6[r * 16 + nt * 8 + 2 * t + (i & 1)]);
          acc[nt][i] += rintf(__fmul_rn(o, 127.f));
        }
      }
    }
  }

  store_mix<MIX, SRC == kSite>(acc, p.out, p.n, s_lo, s_hi, t, p.modes,
                               p.inv_4m);
}

template <int NF, int SRC, int MIX, int HEAD>
int launch(const PlainParams& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<NF>(p.depth);
  auto kern = plain_kernel<NF, SRC, MIX, HEAD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (p.n + kSites - 1) / kSites;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The stage-mix instances of one tap source and head; a site-major output
// has no packed form.
template <int NF, int SRC, int HEAD>
int launch_mix(const PlainParams& p, int mix, cudaStream_t s) {
  switch (mix) {
    case kNone: return launch<NF, SRC, kNone, HEAD>(p, s);
    case kInner: return launch<NF, SRC, kInner, HEAD>(p, s);
    case kFinal: return launch<NF, SRC, kFinal, HEAD>(p, s);
    case kFinalU8: return launch<NF, SRC, kFinalU8, HEAD>(p, s);
    case kFinalPack:
      if constexpr (SRC != kSite)
        return launch<NF, SRC, kFinalPack, HEAD>(p, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

// Checks shared by the entry points; 0 when p may be launched.
inline int check_params(const PlainParams* p) {
  if (p->modes < 1 || p->modes > kMaxModes || p->depth < 0 || p->v < 1 ||
      p->v > 16 || p->n > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

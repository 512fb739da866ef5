// W8A8 plain-unit stage ensemble over a site-major tap matrix (K11), sm_90a.
//
// Replaces the TPU kernels mulut_tpu/ops/unit_kernel.py:_plain_q_kernel,
// _plain_qw6_kernel (requant "f32"; the two differ only in the TPU head
// layout) and _plain_q2_kernel (requant "int"), reached through
// stage_ensemble_apply with a quantized stack (ops/quant.py).  For every
// site n and pass (mode m, rotation r), with t the 4 bf16 taps in columns
// (4m + r)*4 .. +3:
//
//   x  = relu(bf16 chain: sum_k bf16(t[k] * w1[m][k]), then + b1[m])
//   q0 = clip(rint(x), 0, 127)                                int8 codes
//   qd = requant(q(d-1) . hwq[d][m])                           depth layers
//   acc[l] += rint(127 * tanh(fma(q_D . w6q[m][:, 16r + l], c6, b6)))
//
// with the int8 x int8 products summed exactly in int32 and requant, per
// output column, clip(rint(max(fma(float(a), hcq, hbq), 0)), 0, 127)
// ("f32", template INTQ = false) or clip(((a * hmq + hhq) >> hsq) + hbi,
// 0, 127) in int32 with an arithmetic shift ("int", INTQ = true).
//
// The head is the JAX kernels' bf16 broadcast chain: every product and
// partial sum rounded to bf16, in tap order.  XLA computes each bf16 op in
// float32 and rounds the result; here each is one bf16x2 instruction with
// a single rounding (mul.rn / add.rn, never contracted), two features at a
// time.  The two agree exactly: a product of two bf16 values is exact in
// float32, and a float32 sum of two bf16 values is exact unless their
// exponents differ by 16 or more, where both roundings return the larger.
// The dequantizing multiply-adds are single-rounded FMAs, as XLA compiles
// the JAX kernels.  Rounding is half to even; an integer code in [0, 127]
// is rounded by adding 1.5 * 2^23 (its low byte is then the code).  Build
// without --use_fast_math: tanhf must be IEEE.
//
// Bound: operations.  Per site and pass the hidden layers are 2*nf^2*D
// int8 ops (65,536 at nf=128, D=2) against 8 bytes of taps; the int8
// tensor cores bound it.  Design: a block owns 128 consecutive sites, one
// warp 16 of them; the hidden and output products are warp-level
// tensor-core MMAs (mma.sync m16n8k32, s8 x s8 -> s32).  A thread's
// accumulator fragment holds columns {2t, 2t+1} of each 8-column tile,
// while its A fragment takes k-columns {4t .. 4t+3} of each 16-wide half
// of a k32 slice.  So the requantized codes of tiles (0, 1) and (2, 3) of
// each 32-column block are packed, as they lie, into the thread's A
// registers a0/a1 and a2/a3, and the weights' input axis is permuted at
// stack time to match (ops/quant.py k32_feature_order): activations never
// leave the warp's registers and the layers need no block barrier.  The
// mode's int8 weights (D*nf*nf + 64*nf bytes, 40 KB at nf=128, D=2) and
// its requant constants are staged in shared memory once per mode and
// read by all 4 rotations; rows are padded by 16 bytes so the B-fragment
// loads are free of bank conflicts, and a column pair's constants are
// interleaved so one 16-byte load serves the 4 values of a tile.  The head
// (K = 4) and the requant run on the CUDA cores, which take more issue
// slots than the MMAs.  The inner stage (v = 1) computes only the first 8
// output lanes; the others are zero padding and stay 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSites = 16 * kWarps;   // sites per block
constexpr int kHeadRows = 64;         // 4 rotations x 16 output lanes
constexpr int kMaxModes = 6;
constexpr size_t kMaxSmem = 232448;   // 227 KB, the per-block maximum
constexpr float kRound = 12582912.f;  // 1.5 * 2^23

}  // namespace

struct Q8Params {
  const __nv_bfloat16* taps;  // (n, 16M)
  const __nv_bfloat16* w1t;   // (M, nf, 4)
  const __nv_bfloat16* b1;    // (M, nf)
  const int8_t* hwq;          // (D, M, nf, nf): [d][m][out][in, k32 order]
  const void* rq[4];          // (D, M, nf) each: float hcq, hbq ("f32") or
                              // int32 hmq, hhq, hsq, hbi ("int")
  const int8_t* w6q;          // (M, 64, nf): row 16*r + lane, k32 order
  const float* c6;            // (M, 64)
  const float* b6;            // (M, 64)
  float* out;                 // (n, 16)
  long long n;
  int modes, depth, v;
};

namespace {

__device__ __forceinline__ uint32_t ld_b32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_relu(uint32_t a) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(0u));
  return d;
}

// rint(min(x, 127)) for x >= 0, in the low byte of the result.
__device__ __forceinline__ uint32_t code_bits(float x) {
  return __float_as_uint(__fadd_rn(fminf(x, 127.f), kRound));
}

// The low bytes of q0..q3 as bytes 0..3.
__device__ __forceinline__ uint32_t pack4(uint32_t q0, uint32_t q1,
                                          uint32_t q2, uint32_t q3) {
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040),
                     0x5410);
}

// D = A(16x32, row) * B(32x8, col) + D, s8 inputs, s32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows x cols bytes from global (row stride cols) to shared (row stride
// ld), in 16-byte chunks.  cols % 16 == 0; both sides 16-byte aligned.
__device__ __forceinline__ void copy_rows(int8_t* dst, int ld,
                                          const int8_t* src, int rows,
                                          int cols) {
  const int chunks = cols / 16;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    *reinterpret_cast<int4*>(dst + r * ld + 16 * c) =
        __ldg(reinterpret_cast<const int4*>(src + (long long)r * cols + 16 * c));
  }
}

// The ReLU head of features (f, f+1) for one site as a bf16x2 pair.  w1
// holds bf16x2 pairs [k][f/2], b1 pairs [f/2]; tb[k] is tap k in both
// halves.
template <int NF>
__device__ __forceinline__ uint32_t head_pair(const uint32_t* w1,
                                              const uint32_t* b1, int f,
                                              const uint32_t (&tb)[4]) {
  const int i = f >> 1;
  uint32_t s = bf2_mul(tb[0], w1[i]);
#pragma unroll
  for (int k = 1; k < 4; ++k) s = bf2_add(s, bf2_mul(tb[k], w1[k * NF / 2 + i]));
  return bf2_relu(bf2_add(s, b1[i]));
}

// The codes of features f, f+1 (pair p01) and f+8, f+9 (pair p89) packed
// as one A register.
__device__ __forceinline__ uint32_t head_codes(uint32_t p01, uint32_t p89) {
  return pack4(code_bits(__uint_as_float(p01 << 16)),
               code_bits(__uint_as_float(p01 & 0xffff0000u)),
               code_bits(__uint_as_float(p89 << 16)),
               code_bits(__uint_as_float(p89 & 0xffff0000u)));
}

// Next-layer codes of columns (f, f+1) of one tile, from the thread's four
// sums c (rows g and g + 8); rq points at the columns' interleaved
// constants: {hmq, hmq', hhq, hhq'}, {hsq, hsq', hbi, hbi'} ("int") or
// {hcq, hcq', hbq, hbq'} ("f32").  Codes in the low bytes of q[0..3].
template <bool INTQ>
__device__ __forceinline__ void requant_tile(const int (&c)[4],
                                             const uint32_t* rq,
                                             uint32_t (&q)[4]) {
  if (INTQ) {
    const int4 m = *reinterpret_cast<const int4*>(rq);
    const int4 s = *reinterpret_cast<const int4*>(rq + 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = i & 1;
      int ti = c[i] * (e ? m.y : m.x) + (e ? m.w : m.z);
      ti = (ti >> (e ? s.y : s.x)) + (e ? s.w : s.z);
      q[i] = (uint32_t)min(max(ti, 0), 127);
    }
  } else {
    const float4 k = *reinterpret_cast<const float4*>(rq);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = i & 1;
      const float x = __fmaf_rn(__int2float_rn(c[i]), e ? k.y : k.x,
                                e ? k.w : k.z);
      q[i] = code_bits(fmaxf(x, 0.f));
    }
  }
}

// Tap k of a site in both halves of a bf16x2 word (zeros past the end).
__device__ __forceinline__ void load_taps(const __nv_bfloat16* taps,
                                          long long s, long long n, int stride,
                                          int col, uint32_t (&tb)[4]) {
  uint2 raw = make_uint2(0u, 0u);
  if (s < n) raw = *reinterpret_cast<const uint2*>(taps + s * stride + col);
  tb[0] = __byte_perm(raw.x, 0u, 0x1010);
  tb[1] = __byte_perm(raw.x, 0u, 0x3232);
  tb[2] = __byte_perm(raw.y, 0u, 0x1010);
  tb[3] = __byte_perm(raw.y, 0u, 0x3232);
}

// Shared layout: the hidden weights (depth * NF rows of NF + 16 bytes),
// the output head (64 rows of NF + 16 bytes), w1 as bf16 [4][NF], b1 bf16
// [NF], c6 and b6 float [64], then per layer and column pair the 2 * NQ
// interleaved requant words.
template <int NF, bool INTQ>
constexpr size_t smem_bytes(int depth) {
  return (size_t)(depth * NF + kHeadRows) * (NF + 16) + (size_t)5 * NF * 2 +
         (size_t)(2 * kHeadRows + (INTQ ? 4 : 2) * depth * NF) * 4;
}

template <int NF, bool INTQ>
__global__ void __launch_bounds__(kThreads)
plain_w8a8_kernel(const Q8Params p) {
  constexpr int KT = NF / 32;   // k32 slices of an activation
  constexpr int NT = NF / 8;    // n8 tiles of a hidden layer's output
  constexpr int LD = NF + 16;   // padded shared row (bytes)
  constexpr int NQ = INTQ ? 4 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sW = reinterpret_cast<int8_t*>(smem);
  int8_t* sW6 = sW + p.depth * NF * LD;
  __nv_bfloat16* sW1 =
      reinterpret_cast<__nv_bfloat16*>(sW6 + kHeadRows * LD);  // [k][f]
  __nv_bfloat16* sB1 = sW1 + 4 * NF;
  float* sC6 = reinterpret_cast<float*>(sB1 + NF);
  float* sB6 = sC6 + kHeadRows;
  uint32_t* sRQ = reinterpret_cast<uint32_t*>(sB6 + kHeadRows);
  const uint32_t* sW1p = reinterpret_cast<const uint32_t*>(sW1);
  const uint32_t* sB1p = reinterpret_cast<const uint32_t*>(sB1);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const long long s_lo = (long long)blockIdx.x * kSites + warp * 16 + g;
  const long long s_hi = s_lo + 8;
  const int stride = 16 * p.modes;
  const int out_tiles = p.v > 8 ? 2 : 1;

  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int mi = 0; mi < p.modes; ++mi) {
    __syncthreads();  // the previous mode's weights are no longer read
    for (int d = 0; d < p.depth; ++d)
      copy_rows(sW + d * NF * LD, LD,
                p.hwq + ((long long)d * p.modes + mi) * NF * NF, NF, NF);
    copy_rows(sW6, LD, p.w6q + (long long)mi * kHeadRows * NF, kHeadRows, NF);
    for (int i = threadIdx.x; i < 4 * NF; i += kThreads)  // i = k*NF + f
      sW1[i] = p.w1t[(long long)mi * 4 * NF + (i % NF) * 4 + i / NF];
    for (int i = threadIdx.x; i < NF; i += kThreads)
      sB1[i] = p.b1[mi * NF + i];
    for (int i = threadIdx.x; i < kHeadRows; i += kThreads) {
      sC6[i] = p.c6[mi * kHeadRows + i];
      sB6[i] = p.b6[mi * kHeadRows + i];
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {  // constant q: no local copy of p.rq
      const uint32_t* src = static_cast<const uint32_t*>(p.rq[q]);
      for (int i = threadIdx.x; i < p.depth * NF; i += kThreads) {
        const int d = i / NF;
        const int f = i - d * NF;
        sRQ[d * NQ * NF + (f >> 1) * 2 * NQ + 2 * q + (f & 1)] =
            src[((long long)d * p.modes + mi) * NF + f];
      }
    }
    __syncthreads();

    for (int r = 0; r < 4; ++r) {
      const int col = (mi * 4 + r) * 4;
      uint32_t tl[4], th[4];
      load_taps(p.taps, s_lo, p.n, stride, col, tl);
      load_taps(p.taps, s_hi, p.n, stride, col, th);
      // head -> A fragments: a[j][2h] (row g) and a[j][2h + 1] (row g + 8)
      // hold features f, f+1, f+8, f+9 with f = 32j + 16h + 2t
      uint32_t a[KT][4];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 32 * j + 16 * h + 2 * t;
          a[j][2 * h] = head_codes(head_pair<NF>(sW1p, sB1p, f, tl),
                                   head_pair<NF>(sW1p, sB1p, f + 8, tl));
          a[j][2 * h + 1] = head_codes(head_pair<NF>(sW1p, sB1p, f, th),
                                       head_pair<NF>(sW1p, sB1p, f + 8, th));
        }
      }
      for (int d = 0; d < p.depth; ++d) {
        const int8_t* w = sW + d * NF * LD;
        int c[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int8_t* wr = w + (nt * 8 + g) * LD + 32 * j + 4 * t;
            mma_s8(c[nt], a[j], ld_b32(wr), ld_b32(wr + 16));
          }
        }
        // tile n0 = 4j + 2h holds columns f, f+1 and tile n0 + 1 holds
        // f+8, f+9 of this thread's rows: the next layer's A fragment
        const uint32_t* rq = sRQ + d * NQ * NF;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n0 = 4 * j + 2 * h;
            const int f = 8 * n0 + 2 * t;
            uint32_t q0[4], q1[4];
            requant_tile<INTQ>(c[n0], rq + (f >> 1) * 2 * NQ, q0);
            requant_tile<INTQ>(c[n0 + 1], rq + ((f + 8) >> 1) * 2 * NQ, q1);
            a[j][2 * h] = pack4(q0[0], q0[1], q1[0], q1[1]);
            a[j][2 * h + 1] = pack4(q0[2], q0[3], q1[2], q1[3]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (nt >= out_tiles) break;
        int c[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          const int8_t* wr = sW6 + (r * 16 + nt * 8 + g) * LD + 32 * j + 4 * t;
          mma_s8(c, a[j], ld_b32(wr), ld_b32(wr + 16));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = r * 16 + nt * 8 + 2 * t + (i & 1);
          const float o = __fmaf_rn(__int2float_rn(c[i]), sC6[l], sB6[l]);
          acc[nt][i] += rintf(__fmul_rn(tanhf(o), 127.f));
        }
      }
    }
  }

  // acc[nt][i] is site (i < 2 ? s_lo : s_hi), lane nt*8 + 2t + (i & 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long s = h ? s_hi : s_lo;
    if (s >= p.n) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      *reinterpret_cast<float2*>(p.out + s * 16 + nt * 8 + 2 * t) =
          make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
  }
}

template <int NF, bool INTQ>
int launch(const Q8Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<NF, INTQ>(p.depth);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = plain_w8a8_kernel<NF, INTQ>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (p.n + kSites - 1) / kSites;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// One stage of W8A8 plain units: out (n, 16) float32 = the raw
// rotation/mode accumulator.  taps (n, 16M) bf16 contiguous, 8-byte
// aligned; weights as in Q8Params, contiguous, hwq and w6q 16-byte
// aligned.  int_requant selects the "int" constants (else "f32").
// Returns a cudaError_t (0 on success).
extern "C" int plain_w8a8(const Q8Params* p, int nf, int int_requant,
                          void* stream) {
  if (p->n <= 0) return 0;
  if (p->modes < 1 || p->modes > kMaxModes || p->depth < 0 || p->v < 1 ||
      p->v > 16 || p->n > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 128:
      return int_requant ? launch<128, true>(*p, s) : launch<128, false>(*p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

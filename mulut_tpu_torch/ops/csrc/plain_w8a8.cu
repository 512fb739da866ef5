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
// 0, 127) in int32 with an arithmetic shift ("int", INTQ = true).  Every
// step is exact against the plain version (stage_ensemble_apply_q_plain):
// the int8 sums are exact, the head and the dequantizing FMAs round as it
// does, and tanhf is the same IEEE function (build without
// --use_fast_math).
//
// Bound: operations.  Per site and pass the hidden layers are 2*nf^2*D
// int8 ops (65,536 at nf=128, D=2) against 8 bytes of taps; the int8
// tensor cores bound it (2.593 ms per batch of 8 x 3 x 270 x 480 at
// nf=128, depth 2).  The CUDA cores run the head, the requant of every
// hidden activation and 8 tanhf per thread and pass, which take more
// issue slots than the tensor cores' products.
//
// Design (the plain body's shape, plain_body.cuh).  A block owns
// kBlockSites = 768 consecutive sites, 12 tiles of 64, and runs them on 4
// warpgroups at nf=128 (kGroups128, 512 threads, 128 registers each) or
// kGroups = 3 at nf=256 (384 threads, 168 registers), one block per SM; a
// warpgroup runs a tile at a time, each warp 16 of its sites.  Each
// mode's int8 weights and constants are staged once per block with
// cp.async.  Where all modes fit shared memory together (nf=128 up to
// depth 3 at 3 modes) they are staged at once and each tile runs its 4M
// passes with the accumulator in registers; else the mode loop runs
// outside the tiles (net_common.cuh's ensemble_block) and the raw
// accumulators of the block's sites stay in shared memory across modes
// (exact integer sums).  Per pass:
//
//  - the head is the JAX kernels' bf16 broadcast chain in packed bf16x2
//    arithmetic (every product and partial sum rounded once to bf16, in
//    tap order; net_common.cuh's bf2_mul / bf2_add), two features of a
//    site per word.  Its codes come out of three more bf16x2 ops: + b1
//    with the ReLU (fma.rn.relu by 1, one rounding as add.rn), min against
//    127 (the clip), then + 128, which rounds to an integer half to even
//    (bf16 has unit spacing in [128, 256)) and leaves the code in the low
//    7 bits of each half; one byte permute packs the codes of features f,
//    f+1, f+8, f+9 as an A register.  A thread loads a feature pair's 4
//    weights as one 16-byte word and two pairs' biases as one 8-byte word;
//  - each hidden layer is, per n128 half of its outputs (1 at nf=128, 2 at
//    nf=256), one chain of nf/32 wgmma m64n128k32 (s8 x s8 -> s32) with A
//    from registers (the warp's 16 x nf codes, nf/8 registers) and B the
//    layer's staged weights.  Its s32 accumulator fragment holds columns
//    {2t, 2t+1} of each 8-column tile, while A's byte i of a 16-column
//    half takes column 4t + i; so the requantized codes of tiles (2k,
//    2k+1) are packed, as they lie, into the thread's A registers, and the
//    weights' input axis is permuted at stack time to match
//    (ops/quant.py k32_feature_order).  At nf=256 the first half's codes
//    wait in registers while the second half's product still reads A;
//  - the requant: "int" is one multiply-add, a shift and one add with the
//    clip to [0, 127] (min.relu.s32; ptxas fuses the two) per element;
//    "f32" forms float(a) exactly as bits(a + 1.5 * 2^23) - 1.5 * 2^23
//    (|a| <= 127 * 127 * nf < 2^22), one integer add and one float
//    subtract in place of the slow conversion pipe, then the
//    single-rounded FMA, the ReLU and clip, and the round (+ 1.5 * 2^23,
//    the code in the low byte); byte permutes pack both;
//  - the output head is nf/32 wgmma m64n16k32 (m64n8k32 where v <= 8) on
//    rotation r's 16 rows of w6q, dequantized by fma(float(a), c6, b6),
//    then tanhf, rintf(127 * o) and the accumulate.
//
// Shared memory from a 1024-byte-aligned base.  A mode's region: the
// output head (64 rows x nf int8 in K-blocks of 64 rows x 128 columns),
// the hidden layers (nf rows x nf, in K-blocks of nf rows x 128 columns),
// then the vectors: w1 as 16-byte feature-pair words [nf/2], b1 as pair
// words [nf/2] ordered so a thread's two pairs (q, q + 4) are adjacent,
// c6 and b6 float [64], and per layer and column pair the 2 * NQ
// interleaved requant words ({hmq, hmq', hhq, hhq'}, {hsq, hsq', hbi,
// hbi'} for "int"; {hcq, hcq', hbq, hbq'} for "f32").  All modes at once:
// the regions 1024-aligned one after another (142,336 B at nf=128, depth
// 2, 3 modes, "int"); one at a time: the raw accumulators [tile][8][128
// threads] (48 KB), then one region (208,896 B at nf=256, depth 2,
// "int").  The ragged edge is masked per 64-site tile.  The inner stage
// (v = 1) computes only the first 8 output lanes; the others are zero
// padding and stay 0.
//
// Measured: PERF.md (chip_smoke.py on an NVIDIA H100 80GB HBM3).

#include "net_common.cuh"

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

// Launch geometry (chip_smoke.w8a8_grid and friends are its Python copy).
constexpr int kGroups = 3;                      // warpgroups per block
constexpr int kGroups128 = 4;                   // the same at nf=128
constexpr int kTile = 64;                       // sites per warpgroup tile
constexpr int kBlockSites = 768;                // sites per block
constexpr int kAccBase = 0;
constexpr int kW6Base = kAccBase + kBlockSites * 16 * 4;
constexpr int kSmemMax = 232448;                // 227 KB, a block's maximum
constexpr float kRound = 12582912.f;            // 1.5 * 2^23
constexpr uint32_t kRoundBits = 0x4B400000u;    // its bits

template <int NF>
__host__ __device__ constexpr int threads() {
  return 128 * (NF == 128 ? kGroups128 : kGroups);
}

// Byte offsets of a mode's region (output head, layers, vectors) from its
// base, and its size.
template <int NF>
__host__ __device__ constexpr int layer_base() {
  return kHeadRows * NF;
}
template <int NF>
__host__ __device__ constexpr int vec_base(int depth) {
  return layer_base<NF>() + depth * NF * NF;
}
template <int NF, bool INTQ>
__host__ __device__ constexpr int region_bytes(int depth) {
  return vec_base<NF>(depth) + 10 * NF + 2 * kHeadRows * 4 +
         depth * NF * (INTQ ? 4 : 2) * 4;
}
// The mode regions one after the other, 1024-aligned, no accumulators.
template <int NF, bool INTQ>
__host__ __device__ constexpr int region_stride(int depth) {
  return (region_bytes<NF, INTQ>(depth) + 1023) / 1024 * 1024;
}
template <int NF, bool INTQ, bool ALL>
constexpr size_t smem_bytes(int depth, int modes) {
  return ALL ? (size_t)modes * region_stride<NF, INTQ>(depth) + 1024
             : (size_t)kW6Base + region_bytes<NF, INTQ>(depth) +
                   1024;  // + align room
}

// b1's pair q at word p(q) = 8*(q/8) + 2*(q%4) + (q/4)%2, so the pairs q
// and q + 4 that one thread reads (q % 8 < 4) form one 8-byte word.
__device__ __forceinline__ int b1_slot(int q) {
  return (q & ~7) + 2 * (q & 3) + ((q >> 2) & 1);
}

// float(a), exactly, for |a| < 2^22.
__device__ __forceinline__ float exact_float(int a) {
  return __fsub_rn(__uint_as_float((uint32_t)a + kRoundBits), kRound);
}

// The codes of relu(s + b) for a bf16x2 chain sum s and bias b (two
// features of a site): fma(s, 1, b) rounds s + b once, as add.rn does,
// and its .relu is the head's ReLU; then min against 127 (the clip) and
// + 128 rounded to bf16, half to even.  The codes are the low bytes of the
// two halves.
__device__ __forceinline__ uint32_t head_codes(uint32_t s, uint32_t b) {
  uint32_t x, c;
  asm("fma.rn.relu.bf16x2 %0, %1, %2, %3;"
      : "=r"(x) : "r"(s), "r"(0x3F803F80u), "r"(b));
  asm("min.bf16x2 %0, %1, %2;" : "=r"(c) : "r"(x), "r"(0x42FE42FEu));
  return bf2_add(c, 0x43004300u);
}

// Mode mi's weights and constants into its region rg (layout above).  The
// caller's __syncthreads() after it, with each thread's proxy fence here,
// orders the stores before any warpgroup's wgmma reads them.
template <int NF, bool INTQ>
__device__ __forceinline__ void stage_mode(const Q8Params& p, int mi,
                                           unsigned char* rg) {
  constexpr int NQ = INTQ ? 4 : 2;
  const auto bytes = [](int, int c) { return 16 * c; };
  for (int d = 0; d < p.depth; ++d)
    stage_sw128<threads<NF>()>(
        rg + layer_base<NF>() + d * NF * NF,
        p.hwq + ((long long)d * p.modes + mi) * NF * NF, NF, NF, NF,
        NF * 128, bytes);
  stage_sw128<threads<NF>()>(rg, p.w6q + (long long)mi * kHeadRows * NF,
                             kHeadRows, NF, NF, kHeadRows * 128, bytes);
  uint4* sW1 = reinterpret_cast<uint4*>(rg + vec_base<NF>(p.depth));
  uint32_t* sB1 = reinterpret_cast<uint32_t*>(sW1 + NF / 2);
  float* sC6 = reinterpret_cast<float*>(sB1 + NF / 2);
  float* sB6 = sC6 + kHeadRows;
  uint32_t* sRQ = reinterpret_cast<uint32_t*>(sB6 + kHeadRows);
  const __nv_bfloat16* w1 = p.w1t + (long long)mi * NF * 4;  // [f][k]
  const __nv_bfloat16* b1 = p.b1 + (long long)mi * NF;
  for (int q = threadIdx.x; q < NF / 2; q += threads<NF>()) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = bits(w1[8 * q + k]) | bits(w1[8 * q + 4 + k]) << 16;
    sW1[q] = make_uint4(w[0], w[1], w[2], w[3]);
    sB1[b1_slot(q)] = bits(b1[2 * q]) | bits(b1[2 * q + 1]) << 16;
  }
  for (int i = threadIdx.x; i < kHeadRows; i += threads<NF>()) {
    sC6[i] = p.c6[mi * kHeadRows + i];
    sB6[i] = p.b6[mi * kHeadRows + i];
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {  // constant q: no local copy of p.rq
    const uint32_t* src = static_cast<const uint32_t*>(p.rq[q]);
    for (int i = threadIdx.x; i < p.depth * NF; i += threads<NF>()) {
      const int d = i / NF;
      const int f = i - d * NF;
      sRQ[d * NQ * NF + (f >> 1) * 2 * NQ + 2 * q + (f & 1)] =
          src[((long long)d * p.modes + mi) * NF + f];
    }
  }
  stage_wait();  // the copies and stores above, before wgmma reads them
}

// The head of a warp's sites g and g + 8 (taps tl, th from load_taps2) as
// the first layer's A fragments: a[j][2h] (row g) and a[j][2h + 1] (row
// g + 8) hold the codes of features f, f+1, f+8, f+9, f = 32j + 16h + 2t
// (feature pairs q = f/2 and q + 4).
template <int NF>
__device__ __forceinline__ void head(const uint4* sW1, const uint2* sB1,
                                     const uint32_t (&tl)[4],
                                     const uint32_t (&th)[4], int t,
                                     uint32_t (&a)[NF / 32][4]) {
#pragma unroll
  for (int j = 0; j < NF / 32; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 16 * j + 8 * h + t;
      const uint4 w[2] = {sW1[q], sW1[q + 4]};
      const uint2 b = sB1[(q & ~7) / 2 + t];   // pairs q, q + 4
      uint32_t lo[2], hi[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t sl = bf2_mul(tl[0], w[e].x), sh = bf2_mul(th[0], w[e].x);
        sl = bf2_add(sl, bf2_mul(tl[1], w[e].y));
        sh = bf2_add(sh, bf2_mul(th[1], w[e].y));
        sl = bf2_add(sl, bf2_mul(tl[2], w[e].z));
        sh = bf2_add(sh, bf2_mul(th[2], w[e].z));
        sl = bf2_add(sl, bf2_mul(tl[3], w[e].w));
        sh = bf2_add(sh, bf2_mul(th[3], w[e].w));
        lo[e] = head_codes(sl, e ? b.y : b.x);
        hi[e] = head_codes(sh, e ? b.y : b.x);
      }
      a[j][2 * h] = __byte_perm(lo[0], lo[1], 0x6420);
      a[j][2 * h + 1] = __byte_perm(hi[0], hi[1], 0x6420);
    }
  }
}

// The next layer's code of one element from its sum c: m and s are its
// column pair's words (s only for "int"), e = 0 or 1 the column within
// the pair.  The code in the low byte (upper bytes junk for "f32").
template <bool INTQ>
__device__ __forceinline__ uint32_t requant(int c, const uint4& m,
                                            const uint4& s, int e) {
  if constexpr (INTQ) {
    const int ti = (int)((uint32_t)c * (e ? m.y : m.x) + (e ? m.w : m.z));
    const int tq = (int)((uint32_t)(ti >> (int)(e ? s.y : s.x)) +
                         (e ? s.w : s.z));
    uint32_t q;
    asm("min.relu.s32 %0, %1, %2;" : "=r"(q) : "r"(tq), "r"(127));
    return q;
  } else {
    const float x = __fmaf_rn(exact_float(c), __uint_as_float(e ? m.y : m.x),
                              __uint_as_float(e ? m.w : m.z));
    return __float_as_uint(__fadd_rn(fminf(fmaxf(x, 0.f), 127.f), kRound));
  }
}

// The low bytes of q0..q3 as bytes 0..3.
__device__ __forceinline__ uint32_t pack4(uint32_t q0, uint32_t q1,
                                          uint32_t q2, uint32_t q3) {
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040),
                     0x5410);
}

// A layer's n128 half of s32 sums c (tile nt: columns 8nt + 2t, +1 of rows
// g and g + 8), requantized and packed into A registers a[J0 .. J0 + 4):
// tiles (2k, 2k+1) are a[J0 + k/2][2(k%2)] (row g) and [2(k%2) + 1] (row
// g+8).  rq: the half's column-pair words (2 NQ per pair).
template <bool INTQ, int J0, int KA>
__device__ __forceinline__ void requant_half(const int (&c)[64],
                                             const uint32_t* rq, int t,
                                             uint32_t (&a)[KA][4]) {
  constexpr int NQ = INTQ ? 4 : 2;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t q[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int nt = 2 * k + u;
      const uint32_t* w = rq + (nt * 4 + t) * 2 * NQ;
      const uint4 m = *reinterpret_cast<const uint4*>(w);
      const uint4 s = INTQ ? *reinterpret_cast<const uint4*>(w + 4) : m;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[u][i] = requant<INTQ>(c[4 * nt + i], m, s, i & 1);
    }
    a[J0 + (k >> 1)][2 * (k & 1)] = pack4(q[0][0], q[0][1], q[1][0],
                                          q[1][1]);
    a[J0 + (k >> 1)][2 * (k & 1) + 1] = pack4(q[0][2], q[0][3], q[1][2],
                                              q[1][3]);
  }
}

// Rotation r's output lanes, round(127 tanh(fma(float(a), c6, b6))), into
// the accumulator (acc[nt][i]: site g for i < 2 else g + 8, lane nt*8 +
// 2t + (i&1)); NT n8 tiles of the head whose rows start at `rows`.
template <int NF, int NT>
__device__ __forceinline__ void accumulate(float (&acc)[2][4],
                                           const uint32_t (&a)[NF / 32][4],
                                           uint64_t rows, const float* c6,
                                           const float* b6, int t) {
  int c[4 * NT] = {};
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < NF / 32; ++kt) {
    const uint64_t d = rows + (((kt >> 2) * kHeadRows * 128 + (kt & 3) * 32)
                               >> 4);
    if constexpr (NT == 2)
      wgmma_s8_n16(c, a[kt], d, kt);
    else
      wgmma_s8_n8(c, a[kt], d, kt);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(c);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = nt * 8 + 2 * t + (i & 1);
      const float o = __fmaf_rn(exact_float(c[4 * nt + i]), c6[l], b6[l]);
      acc[nt][i] += rintf(__fmul_rn(tanhf(o), 127.f));
    }
  }
}

// One block per SM (142 KB of shared memory at nf=128, depth 2; 209 KB at
// nf=256), so the minimum of 1 block lets ptxas give each thread up to
// 65536 / threads registers: the activations (nf/8), a half layer's
// accumulator (64), at nf=256 the first half's codes (16), the addressing.
// ALL: every mode staged at once (the launch picks it where it fits).
template <int NF, bool INTQ, bool ALL>
__global__ void __launch_bounds__(threads<NF>(), 1)
plain_w8a8_kernel(const Q8Params p) {
  static_assert(NF % 128 == 0, "layers run in n128 halves");
  constexpr int G = threads<NF>() / 128;  // warpgroups
  constexpr int KT = NF / 32;  // k32 steps of an activation
  constexpr int NH = NF / 128;  // n128 halves of a layer
  constexpr int NQ = INTQ ? 4 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint64_t desc = sw128_desc(smem_u32(sm));
  // mode mi's region
  const auto region = [&](int mi) {
    return ALL ? mi * region_stride<NF, INTQ>(p.depth) : kW6Base;
  };

  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  // the warp's 16 rows of the tile
  const int row0 = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const bool wide = p.v > 8;  // two n8 tiles of output lanes

  // a half layer's accumulator; each chain's first wgmma overwrites it
  int c[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) c[i] = 0;

  const auto stage = [&](int mi) {
    stage_mode<NF, INTQ>(p, mi, sm + region(mi));
  };
  const auto pass = [&](float (&acc)[2][4], long long s_lo, int mi, int r) {
    const int rg = region(mi);
    const uint4* sW1 =
        reinterpret_cast<const uint4*>(sm + rg + vec_base<NF>(p.depth));
    const uint2* sB1 = reinterpret_cast<const uint2*>(sW1 + NF / 2);
    const float* sC6 = reinterpret_cast<const float*>(sB1 + NF / 4);
    const float* sB6 = sC6 + kHeadRows;
    const uint32_t* sRQ = reinterpret_cast<const uint32_t*>(sB6 + kHeadRows);
    const int col = (mi * 4 + r) * 4;
    uint32_t tl[4], th[4];
    load_taps2<kSite>(p.taps, p.n, p.modes, nullptr, s_lo, col, tl);
    load_taps2<kSite>(p.taps, p.n, p.modes, nullptr, s_lo + 8, col, th);
    uint32_t a[KT][4];
    head<NF>(sW1, sB1, tl, th, t, a);
#pragma unroll 1
    for (int d = 0; d < p.depth; ++d) {
      const uint64_t w = desc + ((rg + layer_base<NF>() + d * NF * NF) >> 4);
      uint32_t first[4][4];  // the first half's codes (NH = 2)
#pragma unroll
      for (int nh = 0; nh < NH; ++nh) {
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
          wgmma_s8_n128(c, a[kt],
                        w + (((kt >> 2) * NF * 128 + nh * 128 * 128 +
                              (kt & 3) * 32) >> 4),
                        kt);
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(c);
        const uint32_t* rq = sRQ + d * NQ * NF + nh * 64 * 2 * NQ;
        if (nh + 1 < NH) {
          requant_half<INTQ, 0>(c, rq, t, first);
        } else {
          requant_half<INTQ, 4 * (NH - 1)>(c, rq, t, a);
          if constexpr (NH == 2) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) a[j][i] = first[j][i];
          }
        }
      }
    }
    const uint64_t rows = desc + ((rg + r * 16 * 128) >> 4);
    if (wide)
      accumulate<NF, 2>(acc, a, rows, sC6 + 16 * r, sB6 + 16 * r, t);
    else
      accumulate<NF, 1>(acc, a, rows, sC6 + 16 * r, sB6 + 16 * r, t);
  };
  const auto store = [&](const float (&acc)[2][4], long long s_lo) {
    store_mix<kNone, true>(acc, p.out, p.n, s_lo, s_lo + 8, t, p.modes, 0.f);
  };

  if constexpr (ALL) {
    // every mode staged once, then each tile's 4M passes in registers
    for (int mi = 0; mi < p.modes; ++mi) stage(mi);
    __syncthreads();
    const long long block0 = (long long)blockIdx.x * kBlockSites;
#pragma unroll 1
    for (int j = threadIdx.x >> 7; j < kBlockSites / kTile; j += G) {
      if (block0 + j * kTile >= p.n) break;
      const long long s_lo = block0 + j * kTile + row0;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 1
      for (int mi = 0; mi < p.modes; ++mi)
#pragma unroll 1
        for (int r = 0; r < 4; ++r) pass(acc, s_lo, mi, r);
      store(acc, s_lo);
    }
  } else {
    ensemble_block<G, kTile, kBlockSites>(
        p.n, p.modes, reinterpret_cast<float*>(sm + kAccBase), row0, stage,
        pass, store);
  }
}

template <int NF, bool INTQ>
int launch(const Q8Params& p, cudaStream_t stream) {
  const long long blocks = (p.n + kBlockSites - 1) / kBlockSites;
  const size_t all = smem_bytes<NF, INTQ, true>(p.depth, p.modes);
  if (all <= (size_t)kSmemMax)
    return launch_kernel(plain_w8a8_kernel<NF, INTQ, true>, p, blocks,
                         threads<NF>(), all, stream);
  const size_t smem = smem_bytes<NF, INTQ, false>(p.depth, p.modes);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  return launch_kernel(plain_w8a8_kernel<NF, INTQ, false>, p, blocks,
                       threads<NF>(), smem, stream);
}

}  // namespace

// One stage of W8A8 plain units: out (n, 16) float32 = the raw
// rotation/mode accumulator.  taps (n, 16M) bf16 contiguous, 8-byte
// aligned; weights as in Q8Params, contiguous, hwq and w6q 16-byte
// aligned; nf 128 or 256, and depth such that smem_bytes fits a block.
// int_requant selects the "int" constants (else "f32").  Returns a
// cudaError_t (0 on success).
extern "C" int plain_w8a8(const Q8Params* p, int nf, int int_requant,
                          void* stream) {
  if (p->n <= 0) return 0;
  if (p->depth < 0) return (int)cudaErrorInvalidValue;
  if (int e = check_ensemble(p->modes, p->v, p->n)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 128:
      return int_requant ? launch<128, true>(*p, s) : launch<128, false>(*p, s);
    case 256:
      return int_requant ? launch<256, true>(*p, s) : launch<256, false>(*p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

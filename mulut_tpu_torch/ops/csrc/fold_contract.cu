// Fused table gather + weighted group-fold contraction (K1), sm_90a.
//
// Replaces the TPU kernel mulut_tpu/ops/tail_kernel.py:_fold_kernel (reached
// through fold_contract) together with the XLA row gather that fed it:
//
//   out[j, n] = sum_c wt[c, n] * tab[base[n], c*U + j],   c < 16, j < U
//
// emitted as a (U, Np) float32 buffer, the layout the packed cascade's
// un-shift slices and the tail kernel read.  The TPU could not gather table
// rows inside a kernel, so it materialised an (Np, 16*U) int8 gathered
// buffer in HBM first; here each block copies its sites' rows straight from
// the table into shared memory and no gathered buffer exists.
//
// Bound: bytes.  Per site the kernel reads one 16*U-byte table row, 64 bytes
// of weights and writes 4*U bytes; the arithmetic is 16*U int32
// multiply-adds per site, far below the card's integer rate.  The stage-2
// tables (85.5 MB folded s/d rows) exceed the 50 MB L2, so row reads are
// the dominant traffic.  Design: a block owns TN consecutive sites; its
// threads load the TN rows with 16-byte loads (consecutive threads on
// consecutive bytes of a row), store them to shared memory with an odd
// word stride per row (so the contraction's per-site reads hit distinct
// banks), then each thread contracts 4 lanes of one site and writes them
// with the sites on consecutive threads (coalesced stores into (U, Np)).
//
// Exactness: weights are integers <= 2**interval held in float32; they are
// converted to int32 and the 16-term sums are accumulated in int32, then
// stored as float32.  |sum| <= 127 * 16 * 2**interval < 2**24, so the
// result equals the TPU kernel's float32 sums in any order.
//
// Out-of-range base indices are clamped into the table, like jnp.take's
// mode="clip" in the JAX caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCorners = 16;
constexpr int kThreads = 256;

template <int U, int TN>
__global__ void __launch_bounds__(kThreads)
gather_fold_contract_kernel(const int8_t* __restrict__ tab,
                            const int32_t* __restrict__ base,
                            const float* __restrict__ wt,
                            float* __restrict__ out,
                            long long np, long long n_rows) {
  constexpr int kRowBytes = kCorners * U;
  constexpr int kChunks = kRowBytes / 16;       // 16-byte loads per row
  constexpr int kRowWords = kRowBytes / 4 + 1;  // odd: conflict-free reads
  constexpr int kQuads = U / 4;                 // 4 output lanes per thread
  static_assert(kRowBytes % 16 == 0, "rows must be whole 16-byte chunks");
  static_assert(TN % 32 == 0, "a warp must cover consecutive sites");
  __shared__ uint32_t rows[TN * kRowWords];

  const long long n0 = static_cast<long long>(blockIdx.x) * TN;
  for (int i = threadIdx.x; i < TN * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int k = i % kChunks;
    const long long n = n0 + r;
    int4 v = make_int4(0, 0, 0, 0);
    if (n < np) {
      long long b = base[n];
      b = b < 0 ? 0 : (b >= n_rows ? n_rows - 1 : b);
      v = __ldg(reinterpret_cast<const int4*>(tab + b * kRowBytes) + k);
    }
    uint32_t* dst = rows + r * kRowWords + 4 * k;
    dst[0] = static_cast<uint32_t>(v.x);
    dst[1] = static_cast<uint32_t>(v.y);
    dst[2] = static_cast<uint32_t>(v.z);
    dst[3] = static_cast<uint32_t>(v.w);
  }
  __syncthreads();

  for (int p = threadIdx.x; p < TN * kQuads; p += kThreads) {
    const int nl = p % TN;
    const int jq = p / TN;
    const long long n = n0 + nl;
    if (n >= np) continue;
    const uint32_t* row = rows + nl * kRowWords + jq;
    int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
    for (int c = 0; c < kCorners; ++c) {
      const int w = __float2int_rn(__ldg(wt + c * np + n));
      const uint32_t word = row[c * kQuads];  // lanes c*U + 4*jq .. +3
      a0 += w * static_cast<int>(static_cast<int8_t>(word & 0xffu));
      a1 += w * static_cast<int>(static_cast<int8_t>((word >> 8) & 0xffu));
      a2 += w * static_cast<int>(static_cast<int8_t>((word >> 16) & 0xffu));
      a3 += w * static_cast<int>(static_cast<int8_t>(word >> 24));
    }
    float* o = out + static_cast<long long>(4 * jq) * np + n;
    o[0] = static_cast<float>(a0);
    o[np] = static_cast<float>(a1);
    o[2 * np] = static_cast<float>(a2);
    o[3 * np] = static_cast<float>(a3);
  }
}

template <int U, int TN>
void launch(const void* tab, const void* base, const void* wt, void* out,
            long long np, long long n_rows, cudaStream_t stream) {
  const long long blocks = (np + TN - 1) / TN;
  gather_fold_contract_kernel<U, TN><<<static_cast<unsigned>(blocks),
                                       kThreads, 0, stream>>>(
      static_cast<const int8_t*>(tab), static_cast<const int32_t*>(base),
      static_cast<const float*>(wt), static_cast<float*>(out), np, n_rows);
}

}  // namespace

// tab: (n_rows, 16*u) int8, 16-byte aligned; base: (np,) int32;
// wt: (16, np) float32; out: (u, np) float32.  All contiguous, on the
// current device.  Returns a cudaError_t (0 on success).
extern "C" int gather_fold_contract(const void* tab, const void* base,
                                    const void* wt, void* out, long long np,
                                    long long n_rows, int u, void* stream) {
  if (np <= 0) return 0;
  if (n_rows <= 0 || np > (1LL << 36)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (u) {
    case 8:
      launch<8, 128>(tab, base, wt, out, np, n_rows, s);
      break;
    case 16:
      launch<16, 64>(tab, base, wt, out, np, n_rows, s);
      break;
    case 64:
      launch<64, 32>(tab, base, wt, out, np, n_rows, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// Fused table gather + weighted group-fold contraction (K1), sm_90a.
//
// Replaces the TPU kernel mulut_tpu/ops/tail_kernel.py:_fold_kernel (reached
// through fold_contract) together with the XLA row gather that fed it:
//
//   out[j, n] = sum_c wt[c, n] * tab[base[n], c*U + j],   c < C, j < U
//
// with C = 16 (16-corner rows and corner_lams_t weights) or C = 5, 6, 8
// (rank rows and sorted_weights_t weights zero-padded to C, the TPU's
// _contract at :218 over folded_flat's and quad_flat's rank tables),
// emitted as a (U, Np) float32 buffer, the layout the packed cascade's
// un-shift slices and the tail kernel read.  The TPU could not gather table
// rows inside a kernel, so it materialised an (Np, 16*U) int8 gathered
// buffer in HBM first; here each block copies its sites' rows straight from
// the table into shared memory and no gathered buffer exists.
//
// Bound: bytes.  Per site the kernel reads one C*U-byte table row, 4*C bytes
// of weights and writes 4*U bytes; the arithmetic is C*U int32
// multiply-adds per site, far below the card's integer rate.  The stage-2
// tables (85.5 MB folded s/d rows) exceed the 50 MB L2, so row reads are
// the dominant traffic.  Design: a block owns TN consecutive sites; its
// threads load the TN rows with the widest loads the row width keeps
// aligned (16 bytes for rows of a multiple of 16 bytes, 4 for a multiple of
// 4, else single bytes; consecutive threads on consecutive bytes of a row),
// store them to shared memory with an odd word stride per row (so the
// contraction's per-site reads hit distinct banks), then each thread
// contracts 4 lanes of one site (U a multiple of 4) or one lane (U = 9) and
// writes them with the sites on consecutive threads (coalesced stores into
// (U, Np)).
//
// Exactness: weights are integers <= 2**interval held in float32; they are
// converted to int32 and the C-term sums are accumulated in int32, then
// stored as float32.  |sum| <= 127 * 16 * 2**interval < 2**24, so the
// result equals the TPU kernel's float32 sums in any order.
//
// Out-of-range base indices are clamped into the table, like jnp.take's
// mode="clip" in the JAX caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int C, int U, int TN>
__global__ void __launch_bounds__(kThreads)
gather_fold_contract_kernel(const int8_t* __restrict__ tab,
                            const int32_t* __restrict__ base,
                            const float* __restrict__ wt,
                            float* __restrict__ out,
                            long long np, long long n_rows) {
  constexpr int kRowBytes = C * U;
  // bytes per load: the alignment every row start keeps
  constexpr int kVec = kRowBytes % 16 == 0 ? 16 : (kRowBytes % 4 == 0 ? 4 : 1);
  constexpr int kChunks = kRowBytes / kVec;              // loads per row
  constexpr int kWords = (kRowBytes + 3) / 4;
  constexpr int kRowWords = kWords | 1;                  // odd: no conflicts
  constexpr int kGroup = U % 4 == 0 ? 4 : 1;             // lanes per thread
  constexpr int kGroups = U / kGroup;
  static_assert(TN % 32 == 0, "a warp must cover consecutive sites");
  __shared__ uint32_t rows[TN * kRowWords];

  const long long n0 = static_cast<long long>(blockIdx.x) * TN;
  for (int i = threadIdx.x; i < TN * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int k = i % kChunks;
    const long long n = n0 + r;
    long long b = 0;
    if (n < np) {
      b = base[n];
      b = b < 0 ? 0 : (b >= n_rows ? n_rows - 1 : b);
    }
    const int8_t* src = tab + b * kRowBytes + k * kVec;
    uint32_t* dst = rows + r * kRowWords;
    if constexpr (kVec == 16) {
      int4 v = make_int4(0, 0, 0, 0);
      if (n < np) v = __ldg(reinterpret_cast<const int4*>(src));
      dst += 4 * k;
      dst[0] = static_cast<uint32_t>(v.x);
      dst[1] = static_cast<uint32_t>(v.y);
      dst[2] = static_cast<uint32_t>(v.z);
      dst[3] = static_cast<uint32_t>(v.w);
    } else if constexpr (kVec == 4) {
      dst[k] = n < np ? __ldg(reinterpret_cast<const unsigned int*>(src)) : 0u;
    } else {
      reinterpret_cast<int8_t*>(dst)[k] = n < np ? __ldg(src) : 0;
    }
  }
  __syncthreads();

  for (int p = threadIdx.x; p < TN * kGroups; p += kThreads) {
    const int nl = p % TN;
    const int jg = p / TN;
    const long long n = n0 + nl;
    if (n >= np) continue;
    int acc[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) acc[i] = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int w = __float2int_rn(__ldg(wt + c * np + n));
      if constexpr (kGroup == 4) {
        // lanes c*U + 4*jg .. +3: one aligned word of the row
        const uint32_t word = rows[nl * kRowWords + (c * U) / 4 + jg];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i] += w * static_cast<int>(
                            static_cast<int8_t>((word >> (8 * i)) & 0xffu));
        }
      } else {
        const int8_t* row =
            reinterpret_cast<const int8_t*>(rows + nl * kRowWords);
        acc[0] += w * static_cast<int>(row[c * U + jg]);
      }
    }
    float* o = out + static_cast<long long>(kGroup * jg) * np + n;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) o[i * np] = static_cast<float>(acc[i]);
  }
}

template <int C, int U, int TN>
int launch(const void* tab, const void* base, const void* wt, void* out,
           long long np, long long n_rows, cudaStream_t stream) {
  constexpr int kRowBytes = C * U;
  constexpr int kVec = kRowBytes % 16 == 0 ? 16 : (kRowBytes % 4 == 0 ? 4 : 1);
  if (reinterpret_cast<uintptr_t>(tab) % kVec) {
    return cudaErrorMisalignedAddress;
  }
  const long long blocks = (np + TN - 1) / TN;
  gather_fold_contract_kernel<C, U, TN><<<static_cast<unsigned>(blocks),
                                          kThreads, 0, stream>>>(
      static_cast<const int8_t*>(tab), static_cast<const int32_t*>(base),
      static_cast<const float*>(wt), static_cast<float*>(out), np, n_rows);
  return 0;
}

}  // namespace

// tab: (n_rows, c*u) int8; base: (np,) int32; wt: (c, np) float32; out:
// (u, np) float32.  (c, u) is one of (16, 4), (16, 8), (16, 16), (16, 64),
// (5, 4), (5, 9), (5, 16), (5, 36), (6, 64) and (8, 16).  All contiguous,
// on the current device.  Returns a cudaError_t (0 on success).
extern "C" int gather_fold_contract(const void* tab, const void* base,
                                    const void* wt, void* out, long long np,
                                    long long n_rows, int c, int u,
                                    void* stream) {
  if (np <= 0) return 0;
  if (n_rows <= 0 || np > (1LL << 36)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (c * 1000 + u) {
    case 16004:
      err = launch<16, 4, 128>(tab, base, wt, out, np, n_rows, s);
      break;
    case 16008:
      err = launch<16, 8, 128>(tab, base, wt, out, np, n_rows, s);
      break;
    case 16016:
      err = launch<16, 16, 64>(tab, base, wt, out, np, n_rows, s);
      break;
    case 16064:
      err = launch<16, 64, 32>(tab, base, wt, out, np, n_rows, s);
      break;
    case 5004:
      err = launch<5, 4, 128>(tab, base, wt, out, np, n_rows, s);
      break;
    case 5009:
      err = launch<5, 9, 128>(tab, base, wt, out, np, n_rows, s);
      break;
    case 5016:
      err = launch<5, 16, 64>(tab, base, wt, out, np, n_rows, s);
      break;
    case 5036:
      err = launch<5, 36, 64>(tab, base, wt, out, np, n_rows, s);
      break;
    case 6064:
      err = launch<6, 64, 32>(tab, base, wt, out, np, n_rows, s);
      break;
    case 8016:
      err = launch<8, 16, 64>(tab, base, wt, out, np, n_rows, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

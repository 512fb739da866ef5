// Window-read simplex contraction (K1, redesigned for this card), sm_90a.
//
// Replaces the TPU kernel mulut_tpu/ops/tail_kernel.py:_fold_kernel (reached
// through fold_contract, :181) together with the XLA-side work that fed it:
// the tap-plane slices and base/fracs (mulut_tpu/ops/simplex.py:
// _base_and_fracs, :236), the 16-corner weights (corner_lams_t, :201) and
// the table-row gather.  Also runs the inner-stage non-symmetric rotation
// ensemble (mulut_tpu/ops/ensemble.py:rotation_ensemble_lanes_quad_int,
// :110), which had no kernel.  For each site n = (b, y, x) of a grid of
// `lead` x he x we sites and each rotation r:
//
//   p_k  = xp[b, oy + y + dy_rk, ox + x + dx_rk]                    k < 4
//   base = sum_k (p_k >> interval) * L**(3-k),   frac_k = p_k & (q - 1)
//   out[r, j, n] = sum_{k<5} w_k * tab[clamp(base), mask_k * U + j]
//
// with w = (q - s0, s0 - s1, s1 - s2, s2 - s3, s3) the adjacent differences
// of the descending-sorted fractions and mask_k the set of dimensions ranked
// above k (the reference's tie-break: of two equal fractions the later
// letter ranks higher).  These are the five corners where corner_lams_t is
// non-zero, so the sum equals the 16-corner contraction; a tied pair's
// extra vertex has weight 0 either way.  For U > 1 each rotation writes a
// (U, n_sites + 8) float32 buffer, the last 8 sites being junk sites of
// base 0 and fracs 0 (as the JAX callers pad them); for U == 1 (the int8
// (L**4, 16) inner-stage table) the four rotations are summed into one
// int32 accumulator per site.
//
// Bound: bytes.  The function reads the padded plane once, U bytes per
// distinct (row, corner) pair its sites touch and writes 4*U bytes per site
// and rotation (4 bytes per site for U == 1).  At the main path's shapes
// (8 x 3 x 270 x 480) the six calls write ~2.8 GB of (U, N) float32 and
// read ~80 MB of planes; the table rows the sites touch are few enough to
// stay in the 50 MB L2, so the stores bound the kernel.  Design: the tap
// loads, weights, corner masks and the base index stay in registers (the
// (16, N) weight tensor and the base and frac planes of the JAX boundary
// never touch device memory); sites sit on consecutive threads, so the
// tap loads and the (U, N) stores coalesce; only the five live U-byte
// corner groups of a row are loaded (one 8-byte load each at U=8, one
// 16-byte load at U=16, four threads per site with one 16-byte load each
// at U=64, one 16-byte row per rotation at U=1); each thread computes its
// site's weights itself, a few dozen integer instructions beside the loads.
//
// Exactness: every sum is an integer, accumulated in int32;
// |out| <= 127 * q (4 * 127 * q for U == 1) < 2**24, so the float32 store
// equals the plain version's float32 sums in any order.

#include <cuda_runtime.h>
#include <stdint.h>

// Field order must match mulut_tpu_torch/ops/tail_kernel.py:_WindowDesc.
struct WindowDesc {
  long long tap[4][4];  // per rotation, element offsets dy * wp + dx
  long long n_sites;    // lead * he * we
  int n_rot, he, we, hp, wp, oy, ox, interval, L, n_rows;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRot = 4;
constexpr int kJunk = 8;

struct Simplex {
  int row;   // table row, clamped into [0, n_rows)
  int w[5];  // weights of the five simplex vertices
  int m[5];  // their corner masks (bit 3 = a)
};

__device__ __forceinline__ Simplex simplex_of(int pa, int pb, int pc, int pd,
                                              const WindowDesc& d) {
  const int sh = d.interval;
  const int fm = (1 << sh) - 1;
  const int fa = pa & fm, fb = pb & fm, fc = pc & fm, fd = pd & fm;
  const int base =
      (((pa >> sh) * d.L + (pb >> sh)) * d.L + (pc >> sh)) * d.L + (pd >> sh);
  Simplex s;
  s.row = min(max(base, 0), d.n_rows - 1);
  // descending sort: the 5-comparator network of simplex._sorted_fractions
  const int hi_ab = max(fa, fb), lo_ab = min(fa, fb);
  const int hi_cd = max(fc, fd), lo_cd = min(fc, fd);
  const int s0 = max(hi_ab, hi_cd), s3 = min(lo_ab, lo_cd);
  const int mid_hi = min(hi_ab, hi_cd), mid_lo = max(lo_ab, lo_cd);
  const int s1 = max(mid_hi, mid_lo), s2 = min(mid_hi, mid_lo);
  s.w[0] = fm + 1 - s0;
  s.w[1] = s0 - s1;
  s.w[2] = s1 - s2;
  s.w[3] = s2 - s3;
  s.w[4] = s3;
  // descending ranks with the tie-break of simplex._fraction_ranks
  const int cab = fa > fb, cac = fa > fc, cad = fa > fd;
  const int cbc = fb > fc, cbd = fb > fd, ccd = fc > fd;
  const int ra = 3 - cab - cac - cad, rb = 2 + cab - cbc - cbd;
  const int rc = 1 + cac + cbc - ccd, rd = cad + cbd + ccd;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    s.m[k] = (ra < k) << 3 | (rb < k) << 2 | (rc < k) << 1 | (rd < k);
  }
  return s;
}

// Element offset of site n's origin in the plane.
__device__ __forceinline__ long long site_offset(const WindowDesc& d,
                                                 long long n) {
  const long long line = n / d.we;  // b * he + y
  const long long x = n - line * d.we;
  const long long b = line / d.he;
  const long long y = line - b * d.he;
  return (b * d.hp + d.oy + y) * d.wp + d.ox + x;
}

__device__ __forceinline__ void add4(int& a0, int& a1, int& a2, int& a3,
                                     uint32_t word, int w) {
  a0 += w * static_cast<int>(static_cast<int8_t>(word & 0xffu));
  a1 += w * static_cast<int>(static_cast<int8_t>((word >> 8) & 0xffu));
  a2 += w * static_cast<int>(static_cast<int8_t>((word >> 16) & 0xffu));
  a3 += w * static_cast<int>(static_cast<int8_t>(word >> 24));
}

template <int LANES>
__device__ __forceinline__ void load_lanes(const int8_t* p,
                                           uint32_t (&g)[LANES / 4]) {
  if constexpr (LANES == 16) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    g[0] = v.x;
    g[1] = v.y;
    g[2] = v.z;
    g[3] = v.w;
  } else {
    static_assert(LANES == 8, "8 or 16 lanes per thread");
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    g[0] = v.x;
    g[1] = v.y;
  }
}

// U output lanes per site, LANES of them per thread: at U=64 the four
// quarters of 32 consecutive sites go to four warps of the block, so every
// store instruction writes 128 contiguous bytes (four adjacent lanes per
// site wrote four 32-byte pieces and ran slower).  blockIdx.y is the
// rotation.
template <int U>
__global__ void __launch_bounds__(kThreads)
window_fold_kernel(const int32_t* __restrict__ xp,
                   const int8_t* __restrict__ tab, float* __restrict__ out,
                   const WindowDesc d) {
  constexpr int kLanes = U < 16 ? U : 16;
  constexpr int kParts = U / kLanes;
  constexpr int kWords = kLanes / 4;
  const int r = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int part = warp % kParts;
  const long long n = static_cast<long long>(blockIdx.x) * (kThreads / kParts)
                      + (warp / kParts) * 32 + threadIdx.x % 32;
  const long long pitch = d.n_sites + kJunk;
  if (n >= pitch) return;
  int p[4] = {0, 0, 0, 0};  // junk sites: base 0, fracs 0
  if (n < d.n_sites) {
    const int32_t* o = xp + site_offset(d, n);
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = __ldg(o + d.tap[r][k]);
  }
  const Simplex s = simplex_of(p[0], p[1], p[2], p[3], d);
  const int8_t* row =
      tab + static_cast<long long>(s.row) * (16 * U) + part * kLanes;
  uint32_t g[5][kWords];
#pragma unroll
  for (int k = 0; k < 5; ++k) load_lanes<kLanes>(row + s.m[k] * U, g[k]);
  int acc[kLanes];
#pragma unroll
  for (int i = 0; i < kLanes; ++i) acc[i] = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      add4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3],
           g[k][i], s.w[k]);
    }
  }
  float* dst =
      out + (static_cast<long long>(r) * U + part * kLanes) * pitch + n;
#pragma unroll
  for (int i = 0; i < kLanes; ++i) dst[i * pitch] = static_cast<float>(acc[i]);
}

// Byte m of a 16-byte row, sign-extended.
__device__ __forceinline__ int corner_byte(const int4& v, int m) {
  const uint32_t word = (m & 8) ? ((m & 4) ? v.w : v.z)
                                : ((m & 4) ? v.y : v.x);
  return static_cast<int>(static_cast<int8_t>((word >> (8 * (m & 3))) & 0xffu));
}

// U == 1: the four rotations of one site summed into an int32 accumulator.
__global__ void __launch_bounds__(kThreads)
window_quad_sum_kernel(const int32_t* __restrict__ xp,
                       const int8_t* __restrict__ tab,
                       int32_t* __restrict__ out, const WindowDesc d) {
  const long long n =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= d.n_sites) return;
  const int32_t* o = xp + site_offset(d, n);
  int p[kMaxRot][4];
#pragma unroll
  for (int r = 0; r < kMaxRot; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) p[r][k] = __ldg(o + d.tap[r][k]);
  }
  int acc = 0;
#pragma unroll
  for (int r = 0; r < kMaxRot; ++r) {
    const Simplex s = simplex_of(p[r][0], p[r][1], p[r][2], p[r][3], d);
    const int4 v =
        __ldg(reinterpret_cast<const int4*>(tab + 16LL * s.row));
#pragma unroll
    for (int k = 0; k < 5; ++k) acc += s.w[k] * corner_byte(v, s.m[k]);
  }
  out[n] = acc;
}

template <int U>
int launch(const void* xp, const void* tab, void* out, const WindowDesc& d,
           cudaStream_t stream) {
  constexpr int kParts = U > 16 ? U / 16 : 1;
  const long long blocks =
      ((d.n_sites + kJunk) * kParts + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  window_fold_kernel<U><<<dim3(static_cast<unsigned>(blocks), d.n_rot),
                          kThreads, 0, stream>>>(
      static_cast<const int32_t*>(xp), static_cast<const int8_t*>(tab),
      static_cast<float*>(out), d);
  return 0;
}

}  // namespace

// xp: (lead, hp, wp) int32 plane; tab: (n_rows, 16*u) int8, 16-byte
// aligned; out: (n_rot, u, n_sites + 8) float32 for u in {8, 16, 64}, or
// (n_sites,) int32 for u == 1 (then n_rot == 4).  All contiguous, on the
// current device; the caller has checked that every tap stays inside the
// plane.  Returns a cudaError_t (0 on success).
extern "C" int window_fold_contract(const void* xp, const void* tab,
                                    void* out, const WindowDesc* desc, int u,
                                    void* stream) {
  const WindowDesc d = *desc;
  if (d.n_sites <= 0 || d.n_rot < 1 || d.n_rot > kMaxRot || d.n_rows <= 0 ||
      d.interval < 1 || d.interval > 8) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (u) {
    case 1: {
      if (d.n_rot != kMaxRot) return cudaErrorInvalidValue;
      const long long blocks = (d.n_sites + kThreads - 1) / kThreads;
      if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
      window_quad_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(static_cast<const int32_t*>(xp),
                                    static_cast<const int8_t*>(tab),
                                    static_cast<int32_t*>(out), d);
      break;
    }
    case 8:
      err = launch<8>(xp, tab, out, d, s);
      break;
    case 16:
      err = launch<16>(xp, tab, out, d, s);
      break;
    case 64:
      err = launch<64>(xp, tab, out, d, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

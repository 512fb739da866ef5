// Window-read simplex contraction (K1, redesigned for this card), sm_90a.
//
// Replaces the TPU kernel mulut_tpu/ops/tail_kernel.py:_fold_kernel (reached
// through fold_contract, :181, and its dispatcher _contract, :218) together
// with the XLA-side work that fed it: the tap-plane slices and base/fracs
// (mulut_tpu/ops/simplex.py:_base_and_fracs, :236), the 16-corner weights
// (corner_lams_t, :201) or the rank code and sorted weights (_lehmer_code,
// :348; sorted_weights_t, :378) and the table-row gather.  Also runs the
// inner-stage non-symmetric rotation ensemble (mulut_tpu/ops/ensemble.py:
// rotation_ensemble_lanes_quad_int, :110), which had no kernel.  For each
// site n = (b, y, x) of a grid of `lead` x he x we sites and each rotation
// r:
//
//   p_k  = xp[b, oy + y + dy_rk, ox + x + dx_rk]                    k < 4
//   base = sum_k (p_k >> interval) * L**(3-k),   frac_k = p_k & (q - 1)
//   out[r, j, n] = sum_{k<5} w_k * T_r[row, col_k * U + j]
//
// with w = (q - s0, s0 - s1, s1 - s2, s2 - s3, s3) the adjacent differences
// of the descending-sorted fractions and mask_k the set of dimensions ranked
// above k (the reference's tie-break: of two equal fractions the later
// letter ranks higher).  Two row formats:
//
//   16-corner rows (C = 16): row = base, col_k = mask_k.  These are the
//     five corners where corner_lams_t is non-zero, so the sum equals the
//     16-corner contraction; a tied pair's extra vertex has weight 0.
//   rank rows (C >= 5, simplex_tables.rank_fold_lut / rank_expand_*): row =
//     lehmer(ranks) * L**4 + base, col_k = k (the row holds the chain
//     corners in rank order); term blocks past the fifth are zero padding
//     (6 x 64 lanes at x4, 8 x 16 at x2) and are not read.
//
// T_r is one table shared by the rotations, or the r-th of per-rotation
// tables `rot_stride` bytes apart (rank_expand_rotations and the 16-corner
// per-rotation copies, their lane un-rotation baked in).  Rows are `pitch`
// bytes (C * U).  For U > 1 each rotation writes a (U, n_sites + 8) float32
// buffer, the last 8 sites being junk sites of base 0 and fracs 0 (as the
// JAX callers pad them); for U == 1 (the (L**4, 16) inner-stage table, int8
// or int32 rows) the four rotations are summed into one int32 accumulator
// per site.
//
// Bound: bytes.  The function reads the padded plane once, U bytes per
// distinct (row, corner) pair its sites touch and writes 4*U bytes per site
// and rotation (4 bytes per site for U == 1).  At the main path's shapes
// (8 x 3 x 270 x 480) the six calls write ~2.8 GB of (U, N) float32 and
// read ~80 MB of planes; the table rows the sites touch are few enough to
// stay in the 50 MB L2, so the stores bound the kernel.  Design: the tap
// loads, weights, corner masks, rank code and row index stay in registers
// (the (C, N) weight tensor and the base and frac planes of the JAX
// boundary never touch device memory); sites sit on consecutive threads, so
// the tap loads and the (U, N) stores coalesce; only the five live U-byte
// corner groups of a row are loaded, with the widest loads the row pitch
// keeps aligned (16 bytes at U = 16 and 64, 8 at U = 8, 4 at U = 4 and 36,
// single bytes at U = 9, whose 45- and 144-byte rows keep no alignment);
// at U = 64 and 36 the lanes of a site split over 4 and 3 warps (16 and 12
// lanes each), so every store instruction writes 128 contiguous bytes;
// each thread computes its site's weights itself, a few dozen integer
// instructions beside the loads.
//
// Exactness: every sum is an integer, accumulated in int32;
// |out| <= 127 * q (4 * 127 * q for U == 1) < 2**24, so the float32 store
// equals the plain version's float32 sums in any order.

#include <cuda_runtime.h>
#include <stdint.h>

// Field order must match mulut_tpu_torch/ops/tail_kernel.py:_WindowDesc.
struct WindowDesc {
  long long tap[4][4];   // per rotation, element offsets dy * wp + dx
  long long n_sites;     // lead * he * we
  long long pitch;       // bytes per table row
  long long rot_stride;  // bytes between rotations' tables (0: shared)
  int n_rot, he, we, hp, wp, oy, ox, interval, L, n_rows;
  int n_base;            // L**4: rank rows are lehmer * n_base + base
};

namespace {

constexpr int kMaxRot = 4;
constexpr int kJunk = 8;

struct Simplex {
  int base;    // base index (unclamped)
  int lehmer;  // 0..23 code of the descending ranks
  int w[5];    // weights of the five simplex vertices
  int m[5];    // their corner masks (bit 3 = a)
};

__device__ __forceinline__ Simplex simplex_of(int pa, int pb, int pc, int pd,
                                              const WindowDesc& d) {
  const int sh = d.interval;
  const int fm = (1 << sh) - 1;
  const int fa = pa & fm, fb = pb & fm, fc = pc & fm, fd = pd & fm;
  Simplex s;
  s.base =
      (((pa >> sh) * d.L + (pb >> sh)) * d.L + (pc >> sh)) * d.L + (pd >> sh);
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
  // simplex._lehmer_code
  s.lehmer = ra * 6 + (rb - (rb > ra)) * 2 + (rc - (rc > ra) - (rc > rb));
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    s.m[k] = (ra < k) << 3 | (rb < k) << 2 | (rc < k) << 1 | (rd < k);
  }
  return s;
}

// Table row of a site, clamped into [0, n_rows) as jnp.take(mode="clip").
template <bool RANK>
__device__ __forceinline__ long long row_of(const Simplex& s,
                                            const WindowDesc& d) {
  const long long row =
      RANK ? static_cast<long long>(s.lehmer) * d.n_base + s.base : s.base;
  return row < 0 ? 0 : (row >= d.n_rows ? d.n_rows - 1 : row);
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

__device__ __forceinline__ int sbyte(uint32_t word, int i) {
  return static_cast<int>(static_cast<int8_t>((word >> (8 * i)) & 0xffu));
}

// Lane split of U output lanes: kParts threads (in kParts warps) per site,
// kLanes lanes each, loaded kVec bytes at a time (the alignment every row
// pitch at that U keeps: a multiple of 16 * U or 5 * U).
template <int U>
struct LaneSplit {
  static constexpr int kParts = U == 64 ? 4 : (U == 36 ? 3 : 1);
  static constexpr int kLanes = U / kParts;
  static constexpr int kVec = U % 16 == 0 ? 16 : (U % 8 == 0 ? 8
                              : (U % 4 == 0 ? 4 : 1));
  static constexpr int kThreads = 32 * kParts * (kParts == 3 ? 2 : 8 / kParts);
};

// kLanes bytes at p (kVec-aligned) as 32-bit words, or as single bytes in
// the low 8 bits of each word when kVec == 1.
template <int LANES, int VEC>
__device__ __forceinline__ void load_lanes(
    const int8_t* p, uint32_t (&g)[VEC == 1 ? LANES : LANES / 4]) {
  if constexpr (VEC == 16) {
#pragma unroll
    for (int i = 0; i < LANES / 16; ++i) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p) + i);
      g[4 * i] = static_cast<uint32_t>(v.x);
      g[4 * i + 1] = static_cast<uint32_t>(v.y);
      g[4 * i + 2] = static_cast<uint32_t>(v.z);
      g[4 * i + 3] = static_cast<uint32_t>(v.w);
    }
  } else if constexpr (VEC == 8) {
#pragma unroll
    for (int i = 0; i < LANES / 8; ++i) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + i);
      g[2 * i] = v.x;
      g[2 * i + 1] = v.y;
    }
  } else if constexpr (VEC == 4) {
#pragma unroll
    for (int i = 0; i < LANES / 4; ++i) {
      g[i] = __ldg(reinterpret_cast<const unsigned int*>(p) + i);
    }
  } else {
    static_assert(VEC == 1, "16-, 8-, 4- or 1-byte loads");
#pragma unroll
    for (int i = 0; i < LANES; ++i) {
      g[i] = static_cast<uint8_t>(__ldg(p + i));
    }
  }
}

// U output lanes per site; blockIdx.y is the rotation.  The kParts parts
// of 32 consecutive sites go to kParts warps of the block, so every store
// instruction writes 128 contiguous bytes (adjacent lanes of one site on
// adjacent threads wrote 32-byte pieces and ran slower).
template <int U, bool RANK>
__global__ void __launch_bounds__(LaneSplit<U>::kThreads)
window_fold_kernel(const int32_t* __restrict__ xp,
                   const int8_t* __restrict__ tab, float* __restrict__ out,
                   const WindowDesc d) {
  using S = LaneSplit<U>;
  constexpr int kLanes = S::kLanes;
  constexpr int kParts = S::kParts;
  constexpr int kWords = S::kVec == 1 ? kLanes : kLanes / 4;
  const int r = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int part = warp % kParts;
  const long long n =
      static_cast<long long>(blockIdx.x) * (S::kThreads / kParts) +
      (warp / kParts) * 32 + threadIdx.x % 32;
  const long long pitch = d.n_sites + kJunk;
  if (n >= pitch) return;
  int p[4] = {0, 0, 0, 0};  // junk sites: base 0, fracs 0
  if (n < d.n_sites) {
    const int32_t* o = xp + site_offset(d, n);
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = __ldg(o + d.tap[r][k]);
  }
  const Simplex s = simplex_of(p[0], p[1], p[2], p[3], d);
  const int8_t* row = tab + r * d.rot_stride + row_of<RANK>(s, d) * d.pitch +
                      part * kLanes;
  uint32_t g[5][kWords];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    load_lanes<kLanes, S::kVec>(row + (RANK ? k : s.m[k]) * U, g[k]);
  }
  int acc[kLanes];
#pragma unroll
  for (int i = 0; i < kLanes; ++i) acc[i] = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      if constexpr (S::kVec == 1) {
        acc[i] += s.w[k] * static_cast<int>(static_cast<int8_t>(g[k][i]));
      } else {
        acc[i] += s.w[k] * sbyte(g[k][i / 4], i % 4);
      }
    }
  }
  float* dst =
      out + (static_cast<long long>(r) * U + part * kLanes) * pitch + n;
#pragma unroll
  for (int i = 0; i < kLanes; ++i) dst[i * pitch] = static_cast<float>(acc[i]);
}

constexpr int kQuadThreads = 256;

// Byte m of a 16-byte row, sign-extended.
__device__ __forceinline__ int corner_byte(const int4& v, int m) {
  const uint32_t word = (m & 8) ? ((m & 4) ? v.w : v.z)
                                : ((m & 4) ? v.y : v.x);
  return sbyte(word, m & 3);
}

// U == 1: the four rotations of one site summed into an int32 accumulator
// over an (L**4, 16) table of int8 or int32 entries.
template <typename T>
__global__ void __launch_bounds__(kQuadThreads)
window_quad_sum_kernel(const int32_t* __restrict__ xp,
                       const T* __restrict__ tab, int32_t* __restrict__ out,
                       const WindowDesc d) {
  const long long n =
      static_cast<long long>(blockIdx.x) * kQuadThreads + threadIdx.x;
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
    const T* row = tab + 16 * row_of<false>(s, d);
    if constexpr (sizeof(T) == 1) {
      // the whole 16-byte row in one load
      const int4 v = __ldg(reinterpret_cast<const int4*>(row));
#pragma unroll
      for (int k = 0; k < 5; ++k) acc += s.w[k] * corner_byte(v, s.m[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 5; ++k) acc += s.w[k] * __ldg(row + s.m[k]);
    }
  }
  out[n] = acc;
}

template <int U, bool RANK>
int launch(const void* xp, const void* tab, void* out, const WindowDesc& d,
           cudaStream_t stream) {
  using S = LaneSplit<U>;
  const long long sites_per_block = S::kThreads / S::kParts;
  const long long blocks = (d.n_sites + kJunk + sites_per_block - 1) /
                           sites_per_block;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  if (d.pitch % S::kVec || d.rot_stride % S::kVec ||
      reinterpret_cast<uintptr_t>(tab) % S::kVec) {
    return cudaErrorMisalignedAddress;
  }
  window_fold_kernel<U, RANK>
      <<<dim3(static_cast<unsigned>(blocks), d.n_rot), S::kThreads, 0,
          stream>>>(static_cast<const int32_t*>(xp),
                    static_cast<const int8_t*>(tab), static_cast<float*>(out),
                    d);
  return 0;
}

template <int U>
int launch_rows(const void* xp, const void* tab, void* out,
                const WindowDesc& d, int rank, cudaStream_t stream) {
  return rank ? launch<U, true>(xp, tab, out, d, stream)
              : launch<U, false>(xp, tab, out, d, stream);
}

template <typename T>
int launch_quad_sum(const void* xp, const void* tab, void* out,
                    const WindowDesc& d, cudaStream_t stream) {
  if (d.n_rot != kMaxRot || d.pitch != 16 * static_cast<int>(sizeof(T)) ||
      d.rot_stride) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(tab) % 16) return cudaErrorMisalignedAddress;
  const long long blocks = (d.n_sites + kQuadThreads - 1) / kQuadThreads;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  window_quad_sum_kernel<T>
      <<<static_cast<unsigned>(blocks), kQuadThreads, 0, stream>>>(
          static_cast<const int32_t*>(xp), static_cast<const T*>(tab),
          static_cast<int32_t*>(out), d);
  return 0;
}

}  // namespace

// xp: (lead, hp, wp) int32 plane; tab: int8 rows of `pitch` bytes (16-corner
// rows of 16*u bytes, or with rank != 0 rank rows of C*u bytes, C >= 5), one
// table or n_rot tables rot_stride bytes apart; out: (n_rot, u, n_sites + 8)
// float32 for u in {4, 8, 9, 16, 36, 64} (elem_bytes 1).  For u == 1: tab
// (n_rows, 16) entries of elem_bytes (1: int8, 4: int32), one table,
// n_rot == 4, out
// (n_sites,) int32.  All contiguous, on the current device; the caller has
// checked that every tap stays inside the plane.  Returns a cudaError_t
// (0 on success).
extern "C" int window_fold_contract(const void* xp, const void* tab,
                                    void* out, const WindowDesc* desc, int u,
                                    int rank, int elem_bytes, void* stream) {
  const WindowDesc d = *desc;
  if (d.n_sites <= 0 || d.n_rot < 1 || d.n_rot > kMaxRot || d.n_rows <= 0 ||
      d.interval < 1 || d.interval > 8 || d.pitch <= 0 || d.rot_stride < 0 ||
      (rank && d.n_base <= 0)) {
    return cudaErrorInvalidValue;
  }
  if ((u == 1 && rank) ||
      (u > 1 && (elem_bytes != 1 || d.pitch < (rank ? 5LL : 16LL) * u))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (u) {
    case 1:
      if (elem_bytes == 1) {
        err = launch_quad_sum<int8_t>(xp, tab, out, d, s);
      } else if (elem_bytes == 4) {
        err = launch_quad_sum<int32_t>(xp, tab, out, d, s);
      } else {
        return cudaErrorInvalidValue;
      }
      break;
    case 4:
      err = launch_rows<4>(xp, tab, out, d, rank, s);
      break;
    case 8:
      err = launch_rows<8>(xp, tab, out, d, rank, s);
      break;
    case 9:
      err = launch_rows<9>(xp, tab, out, d, rank, s);
      break;
    case 16:
      err = launch_rows<16>(xp, tab, out, d, rank, s);
      break;
    case 36:
      err = launch_rows<36>(xp, tab, out, d, rank, s);
      break;
    case 64:
      err = launch_rows<64>(xp, tab, out, d, rank, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

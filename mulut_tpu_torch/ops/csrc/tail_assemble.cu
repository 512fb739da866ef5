// Final-stage assembly of the packed LUT cascade (K2), sm_90a.
//
// Replaces the TPU kernel mulut_tpu/ops/tail_kernel.py:_tail_kernel (reached
// through tail_assemble).  For every output word (row b*h + y, sub-row py,
// column x < wp) it sums the final stage's rotation ensemble over all modes,
// applies the exact stage mix and packs the 4 sub-pixels of that output
// quad row into one little-endian u32:
//
//   acc[vv] = sum_folded sum_r ext[(b*he + y)*we + off[r] + x, r*16 + vv]
//           + sum_quad   sum_r q_r[(b*(h+1) + y)*wy + x,        perm[r][vv]]
//   vi      = round_half_even(clip(acc, 0, 255*davg) / davg)
//   out     = sum_px vi[4*py + px] << (8*px)
//
// so the output's bytes are the row-major uint8 image.  The contraction
// buffers are read through their strides, so the (u, Np) outputs of the
// fold kernel need no transpose copy.
//
// Bound: bytes.  Each output word reads 4 lanes x 4 rotations of every mode
// (48 float32 for s/d/y) and writes 4 bytes; the arithmetic is a few dozen
// integer operations.  Design: one thread per output word, with x on
// consecutive threads, so every read of a lane is a coalesced run of
// consecutive sites.  The TPU kernel's double-buffered row-block DMAs only
// existed to stage rows in VMEM and are dropped.  The mix is integer
// arithmetic: the inputs are integer-valued float32 below 2**24, so the
// int32 sums and the integer round-half-even equal the TPU's float32 math.

#include <cuda_runtime.h>
#include <stdint.h>

#define MULUT_MAX_MODES 6

// Field order must match mulut_tpu_torch/ops/tail_kernel.py:_TailDesc.
struct TailDesc {
  const float* f_ptr[MULUT_MAX_MODES];
  long long f_rs[MULUT_MAX_MODES];     // element stride between sites
  long long f_ls[MULUT_MAX_MODES];     // element stride between lanes
  const float* q_ptr[MULUT_MAX_MODES][4];
  long long q_rs[MULUT_MAX_MODES][4];
  long long q_ls[MULUT_MAX_MODES][4];
  int f_he[MULUT_MAX_MODES];
  int f_we[MULUT_MAX_MODES];
  int f_off[MULUT_MAX_MODES][4];
  int q_wy[MULUT_MAX_MODES];
  int nf;
  int nq;
  int bc;
  int h;
  int wp;
  int davg;
  signed char q_perm[MULUT_MAX_MODES][4][16];
};

namespace {

constexpr int kThreads = 256;
constexpr int kV = 16;  // scale 4: 16 output lanes per input pixel

__global__ void __launch_bounds__(kThreads)
tail_assemble_kernel(const __grid_constant__ TailDesc d,
                     uint32_t* __restrict__ out, long long total) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int x = static_cast<int>(idx % d.wp);
  const long long t = idx / d.wp;
  const int py = static_cast<int>(t % 4);
  const long long row = t / 4;
  const int y = static_cast<int>(row % d.h);
  const long long b = row / d.h;

  int acc[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < MULUT_MAX_MODES; ++i) {
    if (i >= d.nq) break;
    const long long site = (b * (d.h + 1) + y) * d.q_wy[i] + x;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* p = d.q_ptr[i][r] + site * d.q_rs[i][r];
#pragma unroll
      for (int px = 0; px < 4; ++px) {
        const int lane = d.q_perm[i][r][4 * py + px];
        acc[px] += __float2int_rn(__ldg(p + lane * d.q_ls[i][r]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MULUT_MAX_MODES; ++i) {
    if (i >= d.nf) break;
    const long long row0 = (b * d.f_he[i] + y) * d.f_we[i] + x;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* p = d.f_ptr[i] + (row0 + d.f_off[i][r]) * d.f_rs[i];
#pragma unroll
      for (int px = 0; px < 4; ++px) {
        const int lane = r * kV + 4 * py + px;
        acc[px] += __float2int_rn(__ldg(p + lane * d.f_ls[i]));
      }
    }
  }

  const int top = 255 * d.davg;
  uint32_t packed = 0;
#pragma unroll
  for (int px = 0; px < 4; ++px) {
    const int n = min(max(acc[px], 0), top);
    const int quo = n / d.davg;
    const int rem2 = 2 * (n - quo * d.davg);
    const int up = (rem2 > d.davg) || (rem2 == d.davg && (quo & 1));
    packed |= static_cast<uint32_t>(quo + up) << (8 * px);
  }
  out[idx] = packed;
}

}  // namespace

// d: host descriptor of the mode buffers (device pointers inside);
// out: (bc*h, 4, wp) 32-bit words on the current device.  Returns a
// cudaError_t (0 on success).
extern "C" int tail_assemble(const TailDesc* d, void* out, void* stream) {
  if (d->nf < 0 || d->nf > MULUT_MAX_MODES || d->nq < 0 ||
      d->nq > MULUT_MAX_MODES || d->davg <= 0 || d->h <= 0 || d->wp <= 0)
    return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(d->bc) * d->h * 4 * d->wp;
  if (total <= 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  tail_assemble_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      *d, static_cast<uint32_t*>(out), total);
  return static_cast<int>(cudaGetLastError());
}

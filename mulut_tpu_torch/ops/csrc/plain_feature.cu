// Plain-unit stage ensemble over a feature-major tap matrix (K6), sm_90a.
//
// Replaces the TPU kernels mulut_tpu/ops/unit_kernel.py:_plain_t_kernel,
// _plain_t_rs_kernel and _plain_t_rsiv_kernel (schedules of one function,
// reached through stage_ensemble_apply_t) and their epilogue
// _apply_stage_mix_t: K3's pass (plain_body.cuh, float32 head) over the
// (16M, n) matrix (row (4m + r)*4 + k holds pass (m, r)'s tap k, sites
// along the rows), with K3's stage mixes.  The TPU took this layout to put
// sites in its 128 lanes; on Hopper it only changes where the taps are
// read (4 bf16 loads strided by n per pass, coalesced across the warp).
// Its raw accumulator is K3's, bit for bit.

#include "plain_body.cuh"

// One stage of plain units: taps (16M, n) bf16 contiguous; out and mix as
// in plain_window().  Returns a cudaError_t (0 on success).
extern "C" int plain_feature(const PlainParams* p, int nf, int mix,
                             void* stream) {
  if (p->n <= 0) return 0;
  if (int e = check_params(p, nf)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 128: return launch_mix<128, kFeature, kHeadF32>(*p, mix, s);
    case 256: return launch_mix<256, kFeature, kHeadF32>(*p, mix, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

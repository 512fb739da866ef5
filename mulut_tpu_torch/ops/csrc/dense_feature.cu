// Dense-concat unit stage ensemble over a feature-major tap matrix (K7),
// sm_90a.
//
// Replaces the TPU kernel mulut_tpu/ops/unit_kernel.py:_dense_t_kernel
// (reached through stage_ensemble_apply_t): K4's function (dense_body.cuh)
// over the (16M, n) matrix (row (4m + r)*4 + k holds pass (m, r)'s tap k,
// sites along the rows), with K3's stage-mix epilogue.  The TPU took this
// layout to put sites in its 128 lanes; on Hopper it only changes where
// the taps are read.  Its raw accumulator is K4's, bit for bit.

#include "dense_body.cuh"

// One stage of dense-concat units: taps (16M, n) bf16 contiguous; out and
// mix as in dense_window().  Returns a cudaError_t (0 on success).
extern "C" int dense_feature(const DenseParams* p, int nf, int mix,
                             void* stream) {
  if (p->n <= 0) return 0;
  if (int e = check_params(p)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 64: return launch_mix<64, kFeature>(*p, mix, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dense-concat unit stage ensemble over the flat edge-padded plane (K5),
// sm_90a.
//
// Replaces the TPU kernel mulut_tpu/ops/unit_kernel.py:_dense_w_kernel
// (reached through stage_ensemble_apply_w with a dense stack): K4's
// function (dense_body.cuh), with each pass's taps read straight from the
// plane as K3 reads them (site p's tap (dy, dx) is p + dy*Wp + dx; a tap
// outside [0, n) reads 0; pad-band sites compute values the caller crops)
// and K3's stage-mix epilogue.  The TPU cut the plane into per-tile
// windows because Mosaic cannot index freely; here no tap matrix and no
// window copy exist.  Its raw accumulator is K4's, bit for bit.

#include "dense_body.cuh"

// One stage of dense-concat units over the flat plane (taps = the plane,
// n its length, offs the [mode][rotation][tap] offsets).  out and mix as
// in plain_window(): (16, n) float32 for 0 and 2, (16, n) bf16 for 3,
// (1, n) bf16 for 1, (4, n) uint32 for 4.  Weights as in DenseParams,
// contiguous, wt and w6t 16-byte aligned.  Returns a cudaError_t.
extern "C" int dense_window(const DenseParams* p, int nf, int mix,
                            void* stream) {
  if (p->n <= 0) return 0;
  if (int e = check_params(p)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 64: return launch_mix<64, kPlane>(*p, mix, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

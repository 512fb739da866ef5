// Plain-unit stage ensemble over the flat edge-padded plane (K3), sm_90a.
//
// Replaces the TPU kernel mulut_tpu/ops/unit_kernel.py:_plain_w_kernel
// (reached through stage_ensemble_apply_w, rs schedule) and its epilogue
// _apply_stage_mix_t: plain_body.cuh's pass with the float32 head, each
// pass's taps read straight from the plane (site p's tap (dy, dx) is
// p + dy*Wp + dx, a tap outside [0, n) reads 0, as the TPU's zero-padded
// windows do; pad-band sites compute values the caller crops).  The TPU
// cut the plane into per-tile windows only because Mosaic cannot index
// freely; here no tap matrix and no window copy exist.

#include "plain_body.cuh"

// One stage of plain units over the flat plane (taps = the plane, n its
// length, offs the [mode][rotation][tap] offsets).  out is (16, n) float32
// for mix 0 (raw acc) and 2 (round(acc/M)); (16, n) bf16 for 3 (clip of
// round(acc/M)); (1, n) bf16 for 1 (inner mix / 255); (4, n) uint32 for 4
// (the x4 sub-pixels packed 4 per word, byte sx of word sy = lane
// 4*sy+sx).  Weights as in PlainParams, contiguous; hwt, hws and w6t
// 16-byte aligned.  nf is 128 or 256 (hws then given).  Returns a
// cudaError_t (0 on success).
extern "C" int plain_window(const PlainParams* p, int nf, int mix,
                            void* stream) {
  if (p->n <= 0) return 0;
  if (int e = check_params(p, nf)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 128: return launch_mix<128, kPlane, kHeadF32>(*p, mix, s);
    case 256: return launch_mix<256, kPlane, kHeadF32>(*p, mix, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

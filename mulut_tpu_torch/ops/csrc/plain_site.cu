// Plain-unit stage ensemble over a site-major tap matrix (K8), sm_90a.
//
// Replaces the TPU kernels mulut_tpu/ops/unit_kernel.py:
// _plain_ensemble_kernel, _plain_iv_kernel, _plain_rs_kernel,
// _plain_rsiv_kernel and _make_plain_ivg_kernel (G = 2, 3, 4, 6):
// schedules of one function, reached through stage_ensemble_apply, with
// the head of _plain_head and the epilogue _apply_stage_mix.  K3's pass
// (plain_body.cuh) over the (n, 16M) matrix (columns (4m + r)*4 .. +3 hold
// pass (m, r)'s taps; one 8-byte load per site and pass), with either head
// and a site-major output.  With the float32 head its raw accumulator is
// K3's, bit for bit; the bf16 chain head is a different function.

#include "plain_body.cuh"

// One stage of plain units: taps (n, 16M) bf16 contiguous, 8-byte
// aligned; head 0 is the float32 dot ("mxu"), 1 the bf16 broadcast chain
// ("vpu").  out is (n, 16) float32 for mix 0 (raw acc) and 2
// (round(acc/M)); (n, 16) bf16 for 3 (clip of round(acc/M)); (n, 1) bf16
// for 1 (inner mix / 255); mix 4 (packed) is refused.  Weights as in
// plain_window().  Returns a cudaError_t (0 on success).
extern "C" int plain_site(const PlainParams* p, int nf, int mix, int head,
                          void* stream) {
  if (p->n <= 0) return 0;
  if (int e = check_params(p, nf)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 128:
      if (head == kHeadF32)
        return launch_mix<128, kSite, kHeadF32>(*p, mix, s);
      if (head == kHeadBf16)
        return launch_mix<128, kSite, kHeadBf16>(*p, mix, s);
      return (int)cudaErrorInvalidValue;
    case 256:
      if (head == kHeadF32)
        return launch_mix<256, kSite, kHeadF32>(*p, mix, s);
      if (head == kHeadBf16)
        return launch_mix<256, kSite, kHeadBf16>(*p, mix, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

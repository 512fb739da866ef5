// Dense-concat unit stage ensemble over a site-major tap matrix, sm_90a:
// K4 and K9.
//
// K4 replaces the TPU kernel mulut_tpu/ops/unit_kernel.py:_ensemble_kernel
// (reached through stage_ensemble_apply): for every site n the 4M passes
// of dense_body.cuh over the taps in columns (4m + r)*4 .. +3 of the
// (n, 16M) matrix, and the raw accumulator out.
//
// What bounds it on this card: tensor-core operations (3.1-3.5 ms per
// call at the bench's 3,110,400 sites, 12 passes each), beside the bf16
// chain head and the tanh on the CUDA cores.  Design (dense_body.cuh): a
// block of three warpgroups owns 768 sites; per mode it stages the mode's
// weights once (125 KB, wgmma's swizzled layout) and runs its 12 tiles of
// 64 sites through wgmma chains with A in registers, keeping the raw
// accumulators in shared memory across modes.  Staged bytes: 4,050 blocks
// x 3 modes x 124,800 B, 1.52 GB per call, 3.03 GB per batch (the
// mma.sync body, restaging per 128 sites, ~17.9 GB).
//
// K9 replaces unit_kernel.py:_pair_ensemble_kernel, the same entry with
// the weights of pair_stage_params: two rotations share one matmul there
// through block-diagonal weights, which fill the TPU's 128 MXU lanes at
// nf=64.  The off-diagonal blocks are exact zeros, so K9 computes K4's
// function.  Multiplying the zeros would double the tensor-core work of
// layers 2-5 and of the output head, so this is a kernel written for K9's
// weight layout that computes K9's function: the per-mode staging reads
// the diagonal blocks in place into K4's shared layout (dense_body.cuh's
// stage<PAIRED>), and everything after staging is K4's code, so its
// accumulator is K4's, bit for bit.

#include "dense_body.cuh"

// One stage of dense-concat units: out (n, 16) float32 = the raw
// rotation/mode accumulator.  taps (n, 16M) bf16 contiguous; weights as in
// DenseParams (paired != 0: the rotation-paired layout), contiguous, wt and
// w6t 16-byte aligned.  Returns a cudaError_t (0 on success).
extern "C" int dense_ensemble(const DenseParams* p, int nf, int paired,
                              void* stream) {
  if (p->n <= 0) return 0;
  if (int e = check_params(p)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 64:
      return paired ? launch<64, kSite, kSiteAcc, true>(*p, s)
                    : launch<64, kSite, kSiteAcc, false>(*p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One dense-concat unit alone (K10), sm_90a.
//
// Replaces the TPU kernel mulut_tpu/ops/unit_kernel.py:_kernel (reached
// through fused_unit_apply): one pass of dense_body.cuh per row of an
// (n, 4) tap matrix through the unit's own weights (modes = 1, no rotation
// lanes), and bf16(tanh(.)) of each of its v output columns written out
// instead of accumulated.  v is the output head's width padded to 8 or 16
// as the TPU kernel pads it; the caller slices the real columns.
//
// What bounds it on this card: tensor-core operations (1.0-1.2 ms per
// call at 12,441,600 rows), beside the bf16 chain head and the tanh on
// the CUDA cores.  Design (dense_body.cuh): persistent blocks, as many as
// the card has SMs (read at launch) and no more than the rows need; each
// stages the unit's weights once (89-94 KB, wgmma's swizzled layout) and
// its three warpgroups walk 64-row tiles through wgmma chains with A in
// registers.  Staged bytes: 132 x 88,736 B (v = 8) or 93,888 B (v = 16),
// ~12 MB per call and ~72 MB for the 6 calls of a batch (the mma.sync
// body, restaging per 128 rows, ~51 GB).

#include "dense_body.cuh"

// taps (n, 4) bf16 contiguous, 8-byte aligned; weights as in DenseParams
// with modes = 1 and a (1, v, 5nf) head; out (n, v) bf16.  Returns a
// cudaError_t (0 on success).
extern "C" int dense_unit(const DenseParams* p, int nf, void* stream) {
  if (p->n <= 0) return 0;
  if (int e = check_params(p)) return e;
  if (p->modes != 1 || (p->v != 8 && p->v != 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 64: return launch<64, kUnit, kSiteAcc, false>(*p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

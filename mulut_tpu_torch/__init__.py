"""PyTorch/CUDA port of `mulut_tpu` for NVIDIA Hopper (H100).

Slice 1: the LUT-retrieval deployment path (`pipelines.evaluate.LutEvaluator`
over the packed x4 cascade, `ops.tail_kernel`), with hand-written CUDA kernels
in `ops/csrc/`.  Imports torch and numpy only.
"""

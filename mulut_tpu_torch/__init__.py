"""PyTorch/CUDA port of `mulut_tpu` for NVIDIA Hopper (H100).

Slice 1: the LUT-retrieval deployment path (`pipelines.evaluate.LutEvaluator`
over the packed x4 cascade, `ops.tail_kernel`).  Slice 2: net mode
(`pipelines.evaluate.NetEvaluator`: `models.srnet` over the stage-ensemble
kernels of `ops.unit_kernel`).  Slice 3: W8A8 net mode
(`NetEvaluator(quant=...)`: `ops.quant` and the int8 kernel).  Slices 4-9:
the kernels' other routes and their redesigns for the card.  Slice 10: the
training half, steps 1-3 as PyTorch ops (`pipelines.train`,
`pipelines.transfer`, `pipelines.finetune`, `models.lut_model`, `data`).
Slice 13: how an image or a batch is cut: row bands (`band`) and shards
over several devices (`parallel`, `n_devices`, `gpuNum`, `dryrun`).
Slice 14: distillation (`pipelines.distill`: plain students fitted to
dense teachers, served through net mode's kernels) and the non-SR tasks
(`pipelines.tasks`: denoise and deblock through the x1 LUT cascade,
demosaic through one 12-lane simplex pass).
Slice 15: the command line (`sr_torch/` beside the repo's `sr/`, on
`utils.options`), step 4's CLI functions (`pipelines.evaluate.run_test`,
`eval_dataset`, `process_single_image`), the step runner
(`pipelines.orchestrator`), `utils.profiling` on `torch.profiler`, a PNG
codec of its own (`utils.imgio`), trainPrecision="bf16" and JAX's
optimizer-state checkpoints.
The kernels are hand-written CUDA in `ops/csrc/`.  Imports torch, numpy
and scipy; PIL only inside the functions that resize images or read or
write a file that is not an 8-bit PNG (a JPEG, a palette PNG), matplotlib
only inside the analyzer's plot.
"""

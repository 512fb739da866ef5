#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and hold its
kernels against their plain versions.

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; exits non-zero without them.  Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from `mulut_tpu_torch/ops/csrc/`, and
     ptxas's registers, spills, stack frame and static shared memory of
     every kernel instance by entry name, with its warnings;
  3. `LutEvaluator` construction: x4, 2 stages, modes sdy, interval 4
     (17**4-row int8 LUTs, random from seed 0), tables built on the card;
  4. a recording run of the cascade on the batch, which keeps every
     kernel call's inputs; each call of the window-read simplex
     contraction (`window_fold_contract`, 6 per cascade) is compared byte
     for byte with its plain torch version and with the JAX-boundary
     contraction (`gather_fold_contract`) run on base and 16-corner weights
     built from the same planes, itself compared with its plain version;
     the tail kernel with its plain version;
  5. `LutEvaluator.upscale_batch` on 8 x 270 x 480 x 3 uint8 frames (the
     repo's bench shape) with every launch counter set to 0 just before and
     read just after (6 window contractions, 1 tail, no
     `gather_fold_contract`) and the plain contraction bodies counted
     (`_plain_calls`; no call); one frame is checked byte-equal against
     the port's CPU path;
     then intervals 5 and 6 (random LUTs of their sizes) on a 2 x 135 x 240
     crop, card against the CPU path, byte-equal;
  6. timings with CUDA events: batch ms and output MPix/s, and per kernel
     call site its time, its bound, its plain version's time and one
     `torch.einsum` over the gathered rows (a yardstick, never called by
     the port; `_window_timings`, `_boundary_timings`, shared with phase
     15); a profile of the cascade.

Then net mode (`NetEvaluator(fast=True)`, the tap-MLP units run directly):

  7. plain (mxu-arch) units, the shipped `_ftr2` weights (nf=128, depth 2,
     x4 `sdy`; `artifacts/`), on the same batch: a recording run of
     `upscale_batch` and `upscale_yuv_batch` keeps every window-kernel (K3)
     call's inputs, and each call is held against its plain version at the
     full shapes, raw accumulator and its own epilogue (inner / final /
     final_pack); then both entry points with every launch counter set to
     0 just before and read just after (2 K3 launches each), and a
     135 x 240 crop of frame 0 on the card against the port's CPU path;
  8. dense units (nf=64, depth 4, Kaiming-normal from NumPy seed 0), the
     same checks for the dense ensemble kernel (K4), 2 launches;
  9. timings with CUDA events per kernel call site: ms, bound (useful
     flops over the bf16 tensor-core peak, or bytes over the memory rate),
     plain version, and the same layer chain as cuBLAS bf16 matmuls (a
     yardstick only); `upscale_batch` host ms and MPix/s per architecture;
     a profile of the plain forward; beside each K3 and K4 call site its
     launch geometry (grid, site tile, dynamic shared memory, weight bytes
     staged per call).

Then the W8A8 net mode (`NetEvaluator(quant=...)`, the units quantized to
int8 at construction):

 10. for `quant=True` (integer requant) and `quant="f32"`, the shipped
     `_ftr2` weights (nf=128) and then the nf=256 ones
     (`NET_WEIGHTS_NF256`) through `NetEvaluator.from_checkpoint`: the
     quantization time; every int8-kernel (K11) call of `upscale_batch`
     and `upscale_yuv_batch` on the batch held against its plain version
     (raw accumulator, no entry may differ), with its launch geometry
     (grid, site tile, dynamic shared memory, weight bytes staged per
     call); both entry points with every launch counter set to 0 just
     before and read just after (2 K11 launches each); the 135 x 240 crop
     on the card against the port's CPU path (at nf=256 RGB only); timings:
     K11 per call site (at nf=256 the RGB ones) beside its bound
     (operations over the int8 tensor-core peak, or bytes) and beside the
     same per-stage work as `torch._int_mm` products and torch elementwise
     steps (a yardstick only), `upscale_batch` host ms and MPix/s and
     `srnets_predict_fast` device ms; then every stage stack of the four
     at n = 1, 63, 65, 767, 769 and 1,000,003 on random taps against its
     plain version, no entry differing (`_w8a8_ragged`).

Then the dense-unit routes of net mode (dense units nf=64, seed-0 weights
as in phase 8, the same batch):

 11. first every dense entry (K4, K9, K7, K5 on both stages' stacks; K10
     on a stage-1 and a stage-2 unit) at ragged site counts: n =
     1,000,003 against its plain version, n = 1, 63, 65 and one ensemble
     block's sites -1 and +1 (767, 769) equal to the same sites of a
     launch whose ragged edge lies elsewhere (`_dense_ragged`), with
     their readings against the plain version printed (a tie flip at
     these n is over the 1e-3 share alone, so not gated there), and K9's
     and K7's raw accumulators against K4's (no entry may differ); then
     for each of K5 (`models.srnet.DENSE_LAYOUT = "feature"`, window), K7
     (`"feature"`, `PLAIN_WINDOW = False`) and K9 (MULUT_PAIRED_KERNEL=1):
     `NetEvaluator(fast=True)`; every kernel call of `upscale_batch` held
     against its plain version (raw accumulator and its own epilogue), and
     its raw accumulator against K4's on the same stage input (no entry may
     differ: one pass body); `upscale_batch` with every launch counter set
     to 0 just before and read just after (2 launches of the route's
     kernel, none of another), its bytes equal to the K4 route's; the
     135 x 240 crop on the card against the port's CPU path; timings per
     call site (ms, bound, plain version, cuBLAS chain yardstick), the
     route's `srnets_predict_fast` device ms beside the K4 route's, and
     `upscale_batch` host ms, each call site's launch geometry.  Then K10:
     `srnets_predict(bf16 params, bf16 x, unit_impl="pallas")`, each of
     its 6 unit calls against its plain version, 6 launches counted, the
     crop card vs CPU, timings and geometry.

Then the plain-unit routes of net mode (the `_ftr2` weights, the same
batch):

 12. first every plain entry (K3, K6, K8 with either head, on both
     stages' stacks) at ragged site counts: n = 1,000,003 against its
     plain version, K6's and K8 "mxu"'s raw accumulators against K3's on
     tap matrices gathered from K3's plane (no entry may differ), and n =
     1, 63, 65, 767, 769 equal to the same sites of a launch whose ragged
     edge lies elsewhere, their readings against the plain version printed
     (`_plain_ragged`); K3 on the depth-3 `_ftr2` weights, both stage calls
     of `upscale_batch` against their plain version, the stage's mix at
     the per-call gates, the raw accumulator and the 135 x 240 crop card
     vs CPU at the depth-2 gates with the share gates scaled by the
     measured depth-3 flip rate (ACC_FRAC_D3, U8_EQUAL_D3;
     `_plain_depth3`);
     then for each of K6 (`models.srnet.PLAIN_WINDOW = False`), K8 with the
     float32 head (`PLAIN_LAYOUT = "site"`) and K8 with the bf16 chain head
     (also `ops.unit_kernel.PLAIN_HEAD = "vpu"`): `NetEvaluator(fast=True)`;
     every kernel call of `upscale_batch` and `upscale_yuv_batch` held
     against its plain version (raw accumulator and its own epilogue); for
     the float32 head its raw accumulator against K3's on the same stage
     input, over the image sites (no entry may differ: one pass body);
     both entry points with every launch counter set to 0 just before and
     read just after (2 launches of the route's kernel each, none of
     another), and for the float32 head their bytes equal to the K3
     route's; the 135 x 240 crop on the card against the port's CPU path;
     timings per call site (ms, bound, plain version, cuBLAS chain
     yardstick) with its launch geometry, the route's
     `srnets_predict_fast` device ms beside the K3 route's, and
     `upscale_batch` host ms.

Then the training half (`_training_half`; no kernel of its own: train,
transfer and fine-tune run as PyTorch ops on the card):

 13. a synthetic DIV2K tree written without PIL (HR images from the port's
     `_synth_image`, LR by a 4 x 4 box average, the two pickled caches
     `DIV2K` loads and the HR names it lists), no benchmark tree; step 1
     at the reference width (dense units, nf=64, depth 4, x4, 2 stages,
     `sdy`, batch 32 of 48 x 48 LR crops): one train step's loss and
     every gradient on the card against the port's CPU path from the same
     params and batch (TRAIN_LOSS_REL, TRAIN_GRAD_REL), then
     `train(opt)` for TRAIN["steps"] steps, each step timed with CUDA
     events (median of steps 6 on), the losses finite, peak memory, a
     profile of three steps; step 2:
     `transfer_to_luts` of the trained params and of the `_ftr2` weights
     on the card against the CPU path (at most CACHE_FLIP_SHARE of a
     table's entries off, by one level: tie flips, each counted), ms per
     unit; step 3: from the `_ftr2` tables, `lut_model_forward` on the
     batch byte-equal to the CPU path, one fine-tune step's loss and
     gradients against the CPU path (FT_LOSS_REL, FT_GRAD_REL), then
     `finetune(opt)` for TRAIN["ft_steps"] steps, timed, its peak memory
     and a profile of three steps; the
     deploy: the fine-tuned tables through `LutEvaluator` on the batch of
     phase 5, bytes equal to the CPU path, 6 window contractions and 1
     tail launched, and the cascade and each contraction call site timed
     beside phase 6's random-table times, on the batch and on 8
     structured frames (`_synth_image`).

Then plain net mode at nf=256 (`_plain_nf256`; the plain kernels' nf=256
instances, their hidden layers streamed through a ring of shared-memory
slots):

 14. the nf=256 weights (`NET_WEIGHTS_NF256`, depth 2) through
     `NetEvaluator.from_checkpoint(..., fast=True)` on the same batch:
     every plain entry at ragged site counts as in phase 12; every K3 call
     of `upscale_batch` and `upscale_yuv_batch` against its plain version
     (raw accumulator at ACC_FRAC_NF256, its own epilogue at the nf=128
     gates); both entry points counted (2 K3 launches each, none of
     another); the 135 x 240 crop card vs CPU path, RGB and YUV; timings
     per call site (ms, bound, plain version, cuBLAS chain yardstick) with
     the launch geometry (grid, warpgroups, ring slots and fills, shared
     memory, bytes staged), `srnets_predict_fast` device ms and
     `upscale_batch` host ms; then the K6, K8 "mxu" and K8 "vpu" routes as
     in phase 12 (the crop for "vpu" only: the others must give the K3
     route's bytes).

Then the LUT configurations of the rank-format tables and the integer
cascade (`_lut_rank`; K1 in both forms, K2 at six modes):

 15. on the same batch, interval 4, random int8 LUTs from seed 15 (phase 3's
     for "x4-rank"): "x4-sdyeho" (`LutEvaluator`, the packed cascade over
     the kernel path's formats: rank tables for e/h/o, the (L**4, 64)
     folded and int32 (L**4, 16) inner stages), "x4-rank" (the packed
     cascade on `prepare_expanded_luts(shared_quad=True)`, every final
     stage rank), and "x2-sdy", "x3-sdy", "x2-eho" (`LutEvaluator`, the
     integer cascade `lut_cascade_int` over JAX's default formats: rank
     rows at u = 16, 36 and per-rotation rank tables at u = 4, 9), and
     "x2-s-i3" (x2 "s", one stage, interval 3: L = 33, the 16-corner
     folded (L**4, 256) rows, as tests/test_interval3.py): per
     configuration the table build (ms, bytes, peak memory); every K1 call
     of the cascade against its plain version byte for byte and, where
     fold_contract.cu has an instance, each rotation against the
     JAX-boundary `gather_fold_contract` (C = 5, 6, 8 or 16) on the same
     planes, itself against its plain version (`_k1_checks`, as phase 4);
     at x4 the tail against its
     plain version; the entry point with every launch counter set to 0
     just before and read just after (12 and 6 window contractions, 1
     tail at x4) and the plain contraction bodies counted (no call); for
     "x4-rank" the bytes equal to phase 5's; the 2 x 135 x 240 crop on the
     card against the port's CPU path; timings: the cascade's device ms
     and its glue outside K1 and K2, the entry point's host ms and MPix/s,
     per K1 call site ms, plain ms, bound and an einsum over the gathered
     rows (a yardstick), a profile of the x2 and x3 cascades; after
     "x4-rank", `upscale_yuv_batch` on phase 3's LUTs (6 window
     contractions, 1 tail counted; the crop card vs CPU; host ms); at the
     end the JAX-boundary K1 at C != 16 timed on the recorded inputs, its
     launches the sum of the configurations' counted runs (none).

Then how the port cuts an image or a batch (`_parallel`; K1, K2, K3):

 16. a 4K LR frame (3 x 2160 x 3840, structured, seed 16) on phase 3's
     LUTs through `LutEvaluator(band=256)` and the untiled evaluator: bytes
     equal, K1 and K2 launches (6 and 1 per slab, 9 slabs; 6 and 1),
     device ms and peak memory of each, their ratio; an 8K frame (3 x
     4320 x 7680, which the untiled path cannot hold) banded: peak memory
     below the 4K untiled peak, 3 bands (top, middle, the overlapping
     last) byte-equal to the untiled cascade on their rows widened by 64
     each side, ms and MPix/s; `upscale_many` on 6 frames up to 1100 x
     1900 with bucket 64 and band 128 against bucket 64 alone, bytes
     equal; `cascade_row_sharded` over `make_mesh(4, ["cuda:0"] * 4)` on
     the batch and the 4K frame, bytes equal to the unsharded packed
     cascade (24 and 4 launches); `net_row_sharded` (the `_ftr2` stacks, 8
     K3 launches) and `NetEvaluator(fast=True)` over 4 shards at B = 7
     (RGB and YUV), bytes equal to the unsharded card forward; a train
     step (phase 13's width) and a fine-tune step (the `_ftr2` units'
     tables) on 2 shards against one device: the loss at phase 13's gates,
     the updated params within 1e-6 (the JAX package's
     tests/test_parallel.py), the train gradients at phase 13's gate; the
     fine-tune gradients are sums of two partial sums whose stage-2 tables
     move by more than phase 13's 1e-6 under the split (float32
     summation order: ~4e-6 of their max on the `_ftr2` tables, ~1.5e-6
     on random ones, a reading), so they are held to one device's at
     2e-5, to the same 2-shard step on the CPU path at phase 13's 1e-6,
     and, with every value in float64, to one device's at 1e-12;
     `dryrun_multidevice(4, ["cuda:0"] * 4)`; no plain contraction on the
     LUT paths; the phase's wall time.

Then distillation and the non-SR tasks (`_tasks`; no kernel of their own:
K3 serves the students, K1 and K2 their tables, K1 the x1 cascade):

 17. `distill_srnets` from phase 13's trained dense units (seed-0 ones when
     it did not run; nf=64, depth 4, x4 `sdy`, 2 stages) into plain
     students (nf=128, depth 2) on 65,536 taps per step at interval 4,
     TASKS["distill_steps"] steps per unit, each step timed with CUDA
     events, each unit's lattice metrics; `distill_finetune_cascade`, 16
     crops of 48^2, TASKS["cascade_steps"] steps, timed; the students
     through `NetEvaluator(fast=True)` on the batch: both K3 calls of
     `upscale_batch` against their plain version at phase 7's gates, 2 K3
     launches counted, the 135 x 240 crop card vs CPU path, K3 per call
     site timed; `transfer_to_luts(students)` through `LutEvaluator` (6
     window contractions and 1 tail counted, a 2 x 135 x 240 crop
     byte-equal to the CPU path); `train_dn` at the reference width (dense
     nf=64, `sdy`, 2 stages, 32 x 1 x 48 x 48 crops of structured images,
     sigma 15, TASKS["task_steps"] steps, timed), `dn_transfer` against
     the CPU path (CACHE_FLIP_SHARE), `dn_lut_apply` on a 1080 x 1920 x 3
     structured frame (seed 17) plus noise: each of its 6 K1 calls
     byte-equal to its plain version (and at u=4 to the JAX-boundary K1),
     6 window contractions and no tail counted, a 135 x 240 crop
     byte-equal to the CPU path, the x1 cascade's device ms, the host ms,
     K1 per call site against its bound, a profile, the PSNR gain over the
     noisy frame; `train_dm` (nf=64, 32 x 48 x 48 x 3, timed),
     `dm_transfer`'s (L**4, 12) int8 table, `dm_lut_apply` on the frame's
     mosaic byte-equal to the CPU path, its device and host ms; the
     phase's wall time.

Then the command line (`_cli`; no kernel of its own: its test step runs
K1 and K2):

 18. a PNG tree written by the port's own codec (`utils.imgio`, no PIL):
     CLI["div2k"] structured training images (`data.synthetic`) of
     CLI["hr"]^2 and a Set5 of CLI["set5"] HR sizes, each LR by the port's
     bicubic downscale (`ops.resize`); `run_evaluation("quick", ...,
     synthetic=False)` on the card at the reference width (dense nf=64, x4
     `sdy`, 2 stages, interval 4; the quick preset's 100 train and 20
     fine-tune steps): every step `ok` and `verified`, no error, no
     timeout, no dummy LUTs; its test step counted (6 window contractions
     and 1 tail per image, nothing else); its summary and result PNGs
     equal to `run_test` on the same tables with device="cpu" (files
     byte-equal); `sr_torch/4_test_lut.py` as a process on the same
     folder, its "Dataset Set5" line equal to the summary's;
     `Pipeline(isolate=True)`: the test step in a spawned process (its
     summary equal) and a hanging step killed at its budget; the train
     step in float32 and in bf16 (trainPrecision) on the reference batch
     (32 of 48^2 from the tree) for dense nf=64 and mxu nf=128 units, ms
     per step (CUDA events; the median of 3 rounds of 10 steps, the two
     precisions alternating) beside the card's name and power limit, the
     bf16 step's loss and gradients against the CPU path's bf16 step at
     phase 13's gates; `train(opt)` resumed from the runner's own
     `Model_*.npz` / `Opt_*.npz` (JAX's optimizer-state layout) for 2
     steps; the test step's K1 and K2 call sites on the first Set5 image
     (each against its plain version, timings, a `utils.profiling` trace:
     device busy, idle and gaps, top kernels); the phase's wall time.

Prints a `{"kernels": [...]}` line (K1 in both forms, K2-K11; K8 with the
float32 head; K3, K6 and K8 at nf=256 under names ending in "_nf256"; K1
per phase 15 configuration, K2 at six modes and the JAX-boundary K1 at
C != 16 under names ending in the configuration or "_rank"; phase 17's
K3 as "stage_ensemble_apply_w_students" and K1 as
"window_fold_contract_dn_x1"; phase 18's K1 and K2 as
"window_fold_contract_cli" and "tail_assemble_cli") and
ends with one `{"ok": true, "device": {...}}` line.  Any failed phase
raises.

    python3 chip_smoke.py --plain-ab ROOT [ROOT ...]
    python3 chip_smoke.py --w8a8-ab ROOT [ROOT ...]

compare versions of the plain body, or of K11, on one card instead
(`_plain_ab_one`, `_w8a8_ab_one`): each ROOT holds a version of the port
(for example another commit's `git archive`, unpacked into a directory
`.gitignore` lists), run in the order given, each in a process of its
own.  They print readings only.

    python3 chip_smoke.py --sass [SOURCE ...]

prints each kernel instance's SASS instruction count by opcode
(`cuobjdump`; default source plain_w8a8).

    python3 chip_smoke.py --training
    python3 chip_smoke.py --nf256
    python3 chip_smoke.py --lut-rank
    python3 chip_smoke.py --parallel
    python3 chip_smoke.py --tasks
    python3 chip_smoke.py --cli

build the kernels and run phase 13 (its deploy timings without phase 6's
beside them), phase 14 (with ptxas's report of the plain sources), phase
15 (with ptxas's report of the K1 sources), phase 16, phase 17 (with
seed-0 teachers) or phase 18 alone; readings and gates as in the full
run.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

STAGES, MODES, SCALE, INTERVAL = 2, "sdy", 4, 4
BATCH, H, W = 8, 270, 480
HBM_BYTES_PER_MS = 3.35e9          # H100 SXM: 3.35 TB/s
SOURCE_K1 = "mulut_tpu_torch/ops/csrc/fold_contract.cu"
SOURCE_K1W = "mulut_tpu_torch/ops/csrc/window_fold.cu"
SOURCE_K2 = "mulut_tpu_torch/ops/csrc/tail_assemble.cu"
REPLACES_K1 = "mulut_tpu/ops/tail_kernel.py:181"
REPLACES_K2 = "mulut_tpu/ops/tail_kernel.py:546"
SOURCE_K3 = "mulut_tpu_torch/ops/csrc/plain_window.cu"
SOURCE_K4 = "mulut_tpu_torch/ops/csrc/dense_ensemble.cu"
REPLACES_K3 = "mulut_tpu/ops/unit_kernel.py:1084"
REPLACES_K4 = "mulut_tpu/ops/unit_kernel.py:1281"
SOURCE_K11 = "mulut_tpu_torch/ops/csrc/plain_w8a8.cu"
#: the body quant=True runs; the same kernel replaces _plain_q_kernel
#: (:527) and _plain_qw6_kernel (:564), all reached through :1281
REPLACES_K11 = "mulut_tpu/ops/unit_kernel.py:599"
SOURCE_K5 = "mulut_tpu_torch/ops/csrc/dense_window.cu"
SOURCE_K7 = "mulut_tpu_torch/ops/csrc/dense_feature.cu"
SOURCE_K9 = "mulut_tpu_torch/ops/csrc/dense_ensemble.cu"
SOURCE_K10 = "mulut_tpu_torch/ops/csrc/dense_unit.cu"
SOURCE_K6 = "mulut_tpu_torch/ops/csrc/plain_feature.cu"
SOURCE_K8 = "mulut_tpu_torch/ops/csrc/plain_site.cu"
#: csrc/dense_body.cuh's launch geometry: warpgroups per block (kGroups),
#: sites per warpgroup tile (kTile) and per ensemble block (kBlockSites);
#: the dense kernels' nf, output lanes per pass and the most modes of a
#: launch (net_common.cuh kMaxModes).  tests/test_torch_dense_wgmma.py
#: checks them against the sources.
DENSE_GROUPS, DENSE_TILE, DENSE_BLOCK_SITES = 3, 64, 768
DENSE_NF, DENSE_LANES, DENSE_MAX_MODES = 64, 16, 6
#: csrc/plain_body.cuh's launch geometry (the same warpgroups, tile and
#: block as the dense body); by nf, the slots of the ring its hidden layers
#: stream through (0: every layer staged at once; kWideSlots at nf=256, of
#: PLAIN_SLOT_BYTES each); the most hidden layers it takes (kMaxDepth).
#: tests/test_torch_plain_wgmma.py and test_torch_plain_nf256_layout.py
#: check them against the source.
PLAIN_GROUPS, PLAIN_TILE, PLAIN_BLOCK_SITES = 3, 64, 768
PLAIN_RING_SLOTS = {128: 0, 256: 5}
PLAIN_NFS = tuple(PLAIN_RING_SLOTS)
PLAIN_SLOT_BYTES, PLAIN_MAX_DEPTH = 16384, 4
#: the depth-3 plain weights, for the depth-3 shared-memory layout
NET_WEIGHTS_D3 = "artifacts/mxu_distilled_x4sdy_nf128_d3_ftr2.npz"
#: csrc/plain_w8a8.cu's launch geometry (K11: warpgroups per block by nf,
#: the plain body's tile and block) and its instances' nf; the nf=256
#: weights K11 also runs.  tests/test_torch_w8a8_wgmma.py checks them
#: against the source.
W8A8_GROUPS = {128: 4, 256: 3}
W8A8_TILE, W8A8_BLOCK_SITES = 64, 768
W8A8_NFS = tuple(W8A8_GROUPS)
NET_WEIGHTS_NF256 = "artifacts/mxu_distilled_x4sdy_nf256_d2_ftr2.npz"
#: the JAX bodies (def lines; K5 shares K3's entry :1084, K7 is reached
#: through :1217, K9 through K4's :1281, K10 through :69)
REPLACES_K5 = "mulut_tpu/ops/unit_kernel.py:972"
REPLACES_K7 = "mulut_tpu/ops/unit_kernel.py:802"
REPLACES_K9 = "mulut_tpu/ops/unit_kernel.py:232"
REPLACES_K10 = "mulut_tpu/ops/unit_kernel.py:45"
#: the JAX bodies' first def lines: K6 `_plain_t_kernel` (also :719, :767),
#: K8 `_plain_ensemble_kernel` (also :406, :443, :487, :637)
REPLACES_K6 = "mulut_tpu/ops/unit_kernel.py:681"
REPLACES_K8 = "mulut_tpu/ops/unit_kernel.py:374"
NET_WEIGHTS = "artifacts/mxu_distilled_x4sdy_nf128_d2_ftr2.npz"
BF16_FLOPS_PER_MS = 989e9          # H100 SXM dense bf16 tensor cores
INT8_OPS_PER_MS = 1979e9           # H100 SXM dense int8 tensor cores
FP32_FLOPS_PER_MS = 67e9           # H100 SXM float32, no tensor cores
#: Kernel vs plain version, per call: at most ACC_FRAC of the entries may
#: differ; the mixed outputs by at most MIX_ABS greylevels, the raw
#: accumulator (a sum of 4M rounded passes) by at most RAW_ABS.  Tensor
#: cores sum in another order and precision than cuBLAS, which can flip a
#: bf16 activation and with it one pass's round(127 * tanh) by 1-2
#: (NVIDIA H100 80GB HBM3, this script's batch: 42 of 51 M raw entries
#: off by 2-3, every mixed output within 1).
ACC_FRAC, MIX_ABS, RAW_ABS = 1e-3, 2, 4
#: Card vs CPU path on uint8 images: at least U8_EQUAL of the bytes equal,
#: U8_NEAR within 2 greylevels, none off by more than U8_ABS.  One flipped
#: stage-1 value moves nearby stage-2 outputs by up to ~5 greylevels
#: (NVIDIA H100 80GB HBM3, this script's crop: 2 of 1.56 M bytes off by 5).
U8_EQUAL, U8_NEAR, U8_ABS = 0.999, 0.9999, 8
#: The depth-3 plain weights (NET_WEIGHTS_D3) flip more ties: the gates
#: above were set on the depth-2 ones.  At depth 3 the raw accumulator's
#: share gate and the crop's equal-bytes gate are the depth-2 gates scaled
#: by how much further the port's CPU path departs from JAX at depth 3
#: than at depth 2 on this script's crop (stage 2 raw entries x1.5787,
#: bytes not equal x2.1725; tests/test_torch_net_depth3.py measures it
#: and holds these values to it), rounded to the tighter side; the other
#: gates stay as they are.
ACC_FRAC_D3, U8_EQUAL_D3 = 1.5e-3, 0.998
#: The nf=256 plain weights (NET_WEIGHTS_NF256, phase 14) flip more ties
#: too: each pass rounds twice the activations, each a sum of twice the
#: products.  Their raw share gate is the nf=128 one scaled by how much
#: more often a float32 sum in another order flips a tie at nf=256 than at
#: nf=128: the port's plain version against the same arithmetic with
#: float64 sums, stage 2 of this script's crop on the CPU, 7.99e-4 of the
#: entries at nf=256 against 5.03e-4 at nf=128, x1.588 (the port against
#: JAX departs only x1.477 more: both sum in float32 FMAs);
#: tests/test_torch_net_nf256.py measures both and holds this value to the
#: first, rounded to the tighter side.  The other gates stay as they are.
ACC_FRAC_NF256 = 1.5e-3
CROP_H, CROP_W = 135, 240
#: Phase 13 (the training half): the reference training config (TrainOptions
#: defaults: dense units, nf=64, batch 32 of 48 x 48 LR crops), steps of
#: `train` and `finetune`, the synthetic DIV2K tree's images.
TRAIN = dict(nf=64, batch=32, crop=48, steps=20, ft_steps=10, images=8,
             hr=256)
#: Card vs CPU path on one training step, the CPU tests' tolerances against
#: JAX (tests/test_torch_train.py, test_torch_finetune.py): the loss within
#: relative *_LOSS_REL, each gradient tensor within *_GRAD_REL of its
#: largest magnitude (float32 sums in other orders; a train step's STE
#: rounds may flip a tie).  LUT caching: at most CACHE_FLIP_SHARE of a
#: table's entries off, each by one level (tests/test_torch_transfer.py).
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-5, 1e-4
FT_LOSS_REL, FT_GRAD_REL = 1e-6, 1e-6
CACHE_FLIP_SHARE = 2e-5
#: K10 vs its plain version, in steps of 1/127 of its bf16 tanh outputs:
#: at most ACC_FRAC of the entries may differ, by at most K10_ABS (a
#: flipped bf16 activation or output rounding, as for K4).
K10_ABS = 2


def _random_luts(rng, interval=INTERVAL):
    """Random int8 LUTs of the shipped shapes (as bench.py makes them when
    the reference LUTs are absent)."""
    L = 2 ** (8 - interval) + 1
    luts = {}
    for s in range(STAGES):
        v = SCALE * SCALE if s + 1 == STAGES else 1
        for m in MODES:
            luts[f"s{s + 1}_{m}"] = rng.integers(
                -127, 128, (L ** 4, v), dtype=np.int64).astype(np.int8)
    return luts


def _k128_of(torch, tab):
    """An int8 (R, 16) table spread to the (R, 128) k128 layout (corner m's
    value in lane 8m, other lanes zero): the JAX-boundary K1 takes u >= 8."""
    t = torch.zeros((tab.shape[0], 16, 8), dtype=torch.int8,
                    device=tab.device)
    t[..., 0] = tab
    return t.reshape(-1, 128)


def _cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _record_calls(mod, names, run):
    """Run `run()` with the kernel wrappers `mod.<name>` wrapped so that
    every call's arguments are kept; returns, per name, a list of
    (positional args, keyword args)."""
    calls = {n: [] for n in names}
    orig = {n: getattr(mod, n) for n in names}

    def recorder(n):
        def rec(*args, **kw):
            calls[n].append((args, kw))
            return orig[n](*args, **kw)
        return rec

    for n in names:
        setattr(mod, n, recorder(n))
    try:
        run()
    finally:
        for n in names:
            setattr(mod, n, orig[n])
    return [calls[n] for n in names]


@contextlib.contextmanager
def _plain_calls(tk, sx):
    """Count the calls of the plain contraction bodies (the torch
    gather-and-weight forms K1 stands in for) inside the block."""
    names = [(tk, "gather_fold_contract_plain"),
             (sx, "simplex_planes_quad_int"), (sx, "corner_lams_t"),
             (sx, "sorted_weights_t")]
    counts = {n: 0 for _, n in names}
    saved = [getattr(m, n) for m, n in names]

    def counted(n, fn):
        def wrapper(*args, **kw):
            counts[n] += 1
            return fn(*args, **kw)
        return wrapper

    for (m, n), fn in zip(names, saved):
        setattr(m, n, counted(n, fn))
    try:
        yield counts
    finally:
        for (m, n), fn in zip(names, saved):
            setattr(m, n, fn)


def _window_labels(tk, calls):
    """A label per recorded window call: u, rotations, table shape, dtype
    and row format."""
    out = []
    for (tab, _), kw in calls:
        u = kw["u"]
        C = tk.table_terms(tab, u=u, interval=kw["interval"])[0] if u > 1 \
            else 16
        out.append(f"u={u} rot={len(kw['taps'])} {tuple(tab.shape)} "
                   f"{str(tab.dtype)[6:]} C={C}")
    return out


def _rotation_inputs(tk, tab, xp, kw):
    """Per rotation of a recorded `window_fold_contract` call: its table
    and the JAX-boundary K1's row index, (C, Np+8) weights and C, built
    from the same planes in the table's format (as the TPU's `_contract`
    builds them; 8 junk sites appended)."""
    out = []
    for r, (base, fr) in enumerate(tk.window_base_fracs(
            xp, taps=kw["taps"], origin=kw["origin"], grid=kw["grid"],
            interval=kw["interval"])):
        t = tab[r] if tab.dim() == 3 else tab
        out.append((t,) + tk.boundary_inputs(t, base, fr, u=kw["u"],
                                             interval=kw["interval"]))
    return out


def _k1_checks(torch, tk, calls, labels, what):
    """Each recorded `window_fold_contract` call against its plain version
    byte for byte, at the main path's shapes; where fold_contract.cu has an
    instance, each rotation against `gather_fold_contract` on the same
    planes (`_rotation_inputs`), itself byte-equal to its plain version.
    A u == 1 int8 table is read there through its k128 spread (u = 8,
    `_k128_of`) and the rotations summed; int32 u == 1 rows have no
    instance.  Returns the two forms' max abs errors against their plain
    versions and the JAX-boundary calls at u > 1, labelled, for the
    timings."""
    wf_err = k1_err = 0.0
    bcalls = []
    for label, ((tab, xp), kw) in zip(labels, calls, strict=True):
        got = tk.window_fold_contract(tab, xp, **kw)
        want = tk.window_fold_contract_plain(tab, xp, **kw)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        wf_err = max(wf_err, err)
        if not torch.equal(got, want):
            raise RuntimeError(f"{what}: window_fold_contract differs from "
                               f"plain at {label}: max abs err {err}")
        u, outs = kw["u"], []
        rots = (_rotation_inputs(tk, tab, xp, kw)
                if u > 1 or tab.dtype == torch.int8 else [])
        for r, (t, idx, wt, C) in enumerate(rots):
            kt, ku = (t, u) if u > 1 else (_k128_of(torch, t), 8)
            if (C, ku) not in tk._FOLD_INSTANCES:
                break
            b = tk.gather_fold_contract(kt, idx, wt, C=C, u=ku)
            bp = tk.gather_fold_contract_plain(kt, idx, wt, C=C, u=ku)
            torch.cuda.synchronize()
            err = (b - bp).abs().max().item()
            k1_err = max(k1_err, err)
            if not torch.equal(b, bp):
                raise RuntimeError(f"{what}: gather_fold_contract (C={C}, "
                                   f"u={ku}) differs from plain at {label} "
                                   f"r{r}: max abs err {err}")
            outs.append(b)
            if u > 1:
                bcalls.append((f"{what} {label}"
                               + (f" r{r}" if len(rots) > 1 else ""),
                               t, idx, wt, C, u))
        if outs and not (torch.equal(got, torch.stack(outs)) if u > 1 else
                         torch.equal(got, sum(o[0, :got.numel()]
                                              for o in outs).to(torch.int32))):
            raise RuntimeError(f"{what}: window_fold_contract differs from "
                               f"gather_fold_contract at {label}")
        print(f"{what}: window_fold_contract {label}, grid {xp.shape[0]} x "
              f"{kw['grid']}, out {tuple(got.shape)} {got.dtype}: byte-equal "
              "to plain"
              + (f", and to gather_fold_contract C={rots[0][3]} on each "
                 f"rotation's planes (itself byte-equal to plain)" if outs
                 else ""))
    return wf_err, k1_err, bcalls


def _window_timings(torch, tk, calls, labels, what):
    """Per recorded window call: ms, plain ms, bound and an einsum over
    the gathered rows (a yardstick the port never calls).  The bound is
    bytes: the plane read once, u entries per distinct (row, term) pair of
    non-zero weight (a table shared by the rotations counted once), the
    output written once.  Returns the sums and the ms per label."""
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, einsum_ms=0.0)
    per_site = {}
    for label, ((tab, xp), kw) in zip(labels, calls, strict=True):
        u = kw["u"]
        out = tk.window_fold_contract(tab, xp, **kw)
        n = xp.shape[0] * kw["grid"][0] * kw["grid"][1]
        keys, ein = [], []
        for r, (t, idx, wt, C) in enumerate(_rotation_inputs(tk, tab, xp, kw)):
            if u == 1:              # no junk sites
                idx, wt = idx[:n], wt[:, :n]
            k = torch.arange(C, device=idx.device).view(C, 1)
            rot = r * t.shape[0] if tab.dim() == 3 else 0
            keys.append(torch.unique(((idx.long() + rot) * C + k)[wt > 0]))
            ein.append((t, idx.long(), wt, C))
        n_pairs = torch.unique(torch.cat(keys)).numel()
        nbytes = (xp.numel() * 4 + n_pairs * u * tab.element_size()
                  + out.numel() * 4)
        del out, keys

        def einsums():
            return [torch.einsum("cn,ncu->un", wt, t[idx].view(
                idx.numel(), C, u).float()) for t, idx, wt, C in ein]

        t_ = {
            "ms": _cuda_ms(torch, lambda: tk.window_fold_contract(
                tab, xp, **kw), 20),
            "plain_ms": _cuda_ms(torch, lambda: tk.window_fold_contract_plain(
                tab, xp, **kw), 3),
            "bound_ms": nbytes / HBM_BYTES_PER_MS,
            "einsum_ms": _cuda_ms(torch, einsums, 3),
        }
        del ein
        for key in tot:
            tot[key] += t_[key]
        per_site[label] = t_["ms"]
        print(f"{what}: window_fold_contract {label} sites={n} "
              f"row_term_pairs={n_pairs} bytes={nbytes} "
              + " ".join(f"{k}={v:.4f}" for k, v in t_.items()))
    return tot, per_site


def _k2_plain(tk, folded, quads, kw):
    return tk.tail_assemble_plain(
        folded, quads, bc=int(np.prod(kw["lead"])), h=kw["h"],
        wp=tk._pad128(kw["w"]), scale=kw["scale"], davg=kw["davg"])


def _k2_check(torch, tk, call, what) -> float:
    """A recorded `tail_assemble` call against its plain version, byte for
    byte; returns the max abs error of the packed bytes."""
    (folded, quads), kw = call
    got = tk.tail_assemble(folded, quads, **kw)
    want = _k2_plain(tk, folded, quads, kw)
    torch.cuda.synchronize()
    err = (got.view(torch.uint8).int()
           - want.view(torch.uint8).int()).abs().max().item()
    if not torch.equal(got, want):
        raise RuntimeError(f"{what}: tail_assemble differs from plain: max "
                           f"abs err {err}")
    print(f"{what} tail_assemble: out {tuple(got.shape)} byte-equal to "
          "plain")
    return err


def _k2_timings(torch, tk, call, what) -> dict:
    """ms and plain ms of a recorded `tail_assemble` call and its bytes
    bound (each mode's four f32 planes read once, the packed words
    written once)."""
    (folded, quads), kw = call
    words = (int(np.prod(kw["lead"])) * kw["h"] * kw["scale"]
             * tk._pad128(kw["w"]))
    nmodes = len(folded) + len(quads)
    k2 = {
        "ms": _cuda_ms(torch, lambda: tk.tail_assemble(folded, quads, **kw),
                       20),
        "plain_ms": _cuda_ms(torch, lambda: _k2_plain(tk, folded, quads, kw),
                             3),
        "bound_ms": words * (4 * 4 * nmodes * 4 + 4) / HBM_BYTES_PER_MS,
    }
    print(f"{what} tail_assemble: " + " ".join(f"{k}={v:.4f}"
                                               for k, v in k2.items())
          + " library_ms=none (no single torch call computes it)")
    return k2


def _boundary_timings(torch, tk, bcalls):
    """The JAX-boundary K1 on recorded inputs (`_k1_checks`): ms, plain
    ms, bound (distinct rows read once, the index, weights and output) and
    one einsum over the gathered rows.  Returns the sums."""
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for label, t, idx, wt, C, u in bcalls:
        Np = idx.shape[0]
        rows = torch.unique(idx).numel()
        nbytes = rows * C * u + 4 * Np + 4 * C * Np + 4 * u * Np
        t_ = {
            "ms": _cuda_ms(torch, lambda: tk.gather_fold_contract(
                t, idx, wt, C=C, u=u), 20),
            "plain_ms": _cuda_ms(torch, lambda: tk.gather_fold_contract_plain(
                t, idx, wt, C=C, u=u), 3),
            "bound_ms": nbytes / HBM_BYTES_PER_MS,
            "library_ms": _cuda_ms(torch, lambda: torch.einsum(
                "cn,ncu->un", wt, t[idx.long()].view(Np, C, u).float()), 3),
        }
        for key in tot:
            tot[key] += t_[key]
        print(f"gather_fold_contract {label}: C={C} u={u} Np={Np} "
              f"rows={rows} " + " ".join(f"{k}={v:.4f}"
                                         for k, v in t_.items()))
    return tot


def _profile(torch, cascade, dev_ms: float, runs: int = 3, top: int = 15,
             what: str = "cascade"):
    """Where the device time of `cascade()` (one `what`) goes: torch.profiler
    over `runs` calls, device time per op (self time, per call;
    `utils.profiling.device_rows`)."""
    from torch.profiler import ProfilerActivity, profile

    from mulut_tpu_torch.utils.profiling import device_rows

    cascade()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            cascade()
        torch.cuda.synchronize()
    kernels, ops = device_rows(prof, runs)
    if not kernels:
        print("profile: the profiler recorded no device time (not measured)")
        return
    busy = sum(r[0] for r in kernels)
    print(f"profile: device busy {busy:.3f} ms of {dev_ms:.3f} ms per "
          f"{what} (idle share {max(0.0, 1 - busy / dev_ms):.3f})")
    for title, rows in (("kernels", kernels), ("torch ops", ops)):
        print(f"profile, top {title} by device time per {what}:")
        for ms, n, name in sorted(rows, reverse=True)[:top]:
            print(f"  {ms:8.3f} ms  x{n:<4d} {name[:100]}")


def _ptxas_report(logs):
    """Registers, spills, stack frame and static shared memory of every
    kernel instance in ptxas's `-v` report, by entry name (demangled where
    `c++filt` is found), and every ptxas warning (a serialised wgmma
    pipeline shows there as a performance-loss note)."""
    import re
    import shutil

    for src, log in logs.items():
        entries, cur = [], None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = {"name": m.group(1)}
                entries.append(cur)
            elif "warning" in line.lower() or "Performance Loss" in line:
                print(f"  ptxas {src} warning: {line.strip()}")
            elif cur is not None:
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", line)
                if m:
                    cur["stack"], cur["spill_st"], cur["spill_ld"] = m.groups()
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    cur["regs"] = m.group(1)
                    m = re.search(r"(\d+) bytes smem", line)
                    cur["smem"] = m.group(1) if m else "0"
        names = [e["name"] for e in entries]
        if names and shutil.which("c++filt"):
            out = subprocess.run(["c++filt"], input="\n".join(names),
                                 capture_output=True, text=True, timeout=60)
            if out.returncode == 0 and len(out.stdout.splitlines()) == \
                    len(names):
                names = out.stdout.splitlines()
        for e, name in zip(entries, names):
            print(f"  ptxas {src}: {name}: {e.get('regs', '?')} registers, "
                  f"spill stores {e.get('spill_st', '?')} B, spill loads "
                  f"{e.get('spill_ld', '?')} B, stack {e.get('stack', '?')} "
                  f"B, static smem {e.get('smem', '?')} B")


def dense_grid(n: int, *, unit: bool, sms: int) -> int:
    """Blocks of a dense launch over n sites, the rule of the C entries:
    one per DENSE_BLOCK_SITES sites for an ensemble (K4, K5, K7, K9); for
    one unit (K10), persistent blocks, at most one per SM (`sms`) and no
    more than its tiles need."""
    if unit:
        tiles = -(-n // DENSE_TILE)
        return min(sms, -(-tiles // DENSE_GROUPS))
    return -(-n // DENSE_BLOCK_SITES)


def dense_smem_bytes(*, unit: bool) -> int:
    """Dynamic shared memory of a dense launch: the staged weights (10
    64 x 64 K-blocks of concat layers and 5 of output head, bf16), w1 and
    b1 as bf16, the other biases as float, the plane offsets, the
    ensembles' raw accumulators (16 float per site of the block) and 1 KB
    to align the base."""
    acc = 0 if unit else DENSE_BLOCK_SITES * DENSE_LANES * 4
    nf = DENSE_NF
    return (15 * 64 * 128 + 2 * 5 * nf + 4 * (4 * nf + 4 * DENSE_LANES)
            + DENSE_MAX_MODES * 16 * 4 + acc + 1024)


def dense_staged_bytes(n: int, *, modes: int, v: int, unit: bool,
                       sms: int) -> int:
    """Shared-memory bytes one dense launch stages: per block and mode the
    bf16 concat layers, output head (64 rows; a unit's v), w1 and b1, and
    the float hidden biases and b6."""
    rows, nf = (v if unit else 4 * DENSE_LANES), DENSE_NF
    per_mode = (2 * (10 * nf * nf + rows * 5 * nf + 5 * nf)
                + 4 * (4 * nf + rows))
    return dense_grid(n, unit=unit, sms=sms) * modes * per_mode


def _dense_geometry(torch, n, *, modes, v, unit):
    """One dense call's launch geometry: grid, site tile, dynamic shared
    memory and the weight bytes staged into it per call."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = dense_grid(n, unit=unit, sms=sms)
    blocks = (f"persistent, at most one block on each of {sms} SMs" if unit
              else f"{DENSE_BLOCK_SITES} sites per block")
    staged = dense_staged_bytes(n, modes=modes, v=v, unit=unit, sms=sms)
    return (f"grid={grid} x {128 * DENSE_GROUPS} threads, site tile "
            f"{DENSE_TILE} per warpgroup ({blocks}), dynamic smem "
            f"{dense_smem_bytes(unit=unit)} B, staged_bytes={staged}")


def plain_grid(n: int) -> int:
    """Blocks of a plain launch over n sites (K3, K6, K8): one per
    PLAIN_BLOCK_SITES sites."""
    return -(-n // PLAIN_BLOCK_SITES)


def plain_smem_bytes(depth: int, nf: int = 128) -> int:
    """Dynamic shared memory of a plain launch.  nf=128: the output head
    (64 rows x nf bf16), the raw accumulators (16 float per site of the
    block), the vectors (b1, b6 and PLAIN_MAX_DEPTH hidden biases as float,
    4 nf words for the head's w1, the plane offsets) rounded up to 1 KB,
    then `depth` nf x nf bf16 layers and 1 KB to align the base.  nf=256:
    the output head, the raw accumulators as int16, the stash (three
    quarters of a layer's packed outputs, 24 KB per warpgroup), the
    vectors and the ring's barriers and release counts (12 B a slot)
    rounded up to 1 KB, then the ring and 1 KB; the same at any depth."""
    vec = 4 * (nf + 64 + PLAIN_MAX_DEPTH * nf + 4 * nf
               + DENSE_MAX_MODES * 16)
    slots = PLAIN_RING_SLOTS[nf]
    if not slots:
        fixed = 64 * nf * 2 + PLAIN_BLOCK_SITES * 16 * 4 + vec
        return -(-fixed // 1024) * 1024 + depth * nf * nf * 2 + 1024
    fixed = (64 * nf * 2 + PLAIN_BLOCK_SITES * 16 * 2
             + PLAIN_GROUPS * 12 * 128 * 16 + vec + 12 * slots)
    return -(-fixed // 1024) * 1024 + slots * PLAIN_SLOT_BYTES + 1024


def plain_ring_fills(n: int, *, modes: int, depth: int) -> int:
    """Ring fills (PLAIN_SLOT_BYTES each) of a plain launch at nf=256 over
    n sites: a block runs ceil(live tiles / PLAIN_GROUPS) tile rounds per
    mode, and each round's 4 passes read each layer's 8 fills (4 quarters
    of its outputs by 2 halves of its inputs)."""
    full, rest = divmod(n, PLAIN_BLOCK_SITES)

    def rounds(sites):
        return -(-(-(-sites // PLAIN_TILE)) // PLAIN_GROUPS)

    r = full * rounds(PLAIN_BLOCK_SITES) + (rounds(rest) if rest else 0)
    return r * modes * 4 * 8 * depth


def plain_staged_bytes(n: int, *, modes: int, depth: int, head: str,
                       nf: int = 128) -> int:
    """Shared-memory bytes one plain launch stages: per block and mode the
    bf16 output head, the float hidden biases and b6, and the head's
    weights (w1 and b1 as bf16 pairs; at nf=128 as float for the float32
    head, "mxu"); the hidden layers per block and mode at nf=128, through
    the ring's fills at nf=256."""
    per_mode = 2 * 64 * nf + 4 * (depth * nf + 64)
    per_mode += 4 * 5 * nf if head == "mxu" and nf == 128 else 2 * 5 * nf
    if not PLAIN_RING_SLOTS[nf]:
        per_mode += 2 * depth * nf * nf
        return plain_grid(n) * modes * per_mode
    return (plain_grid(n) * modes * per_mode
            + plain_ring_fills(n, modes=modes, depth=depth) * PLAIN_SLOT_BYTES)


def _plain_geometry(n, *, modes, depth, head, nf=128):
    """One plain call's launch geometry: grid, site tile, dynamic shared
    memory, the ring at nf=256, and the weight bytes staged into shared
    memory per call."""
    staged = plain_staged_bytes(n, modes=modes, depth=depth, head=head,
                                nf=nf)
    slots = PLAIN_RING_SLOTS[nf]
    ring = (f", ring of {slots} x {PLAIN_SLOT_BYTES} B slots, "
            f"{plain_ring_fills(n, modes=modes, depth=depth)} fills"
            if slots else "")
    return (f"grid={plain_grid(n)} x {128 * PLAIN_GROUPS} threads "
            f"({PLAIN_GROUPS} warpgroups), site tile {PLAIN_TILE} per "
            f"warpgroup ({PLAIN_BLOCK_SITES} sites per block), dynamic smem "
            f"{plain_smem_bytes(depth, nf)} B{ring}, staged_bytes={staged}")


def w8a8_grid(n: int) -> int:
    """Blocks of a K11 launch over n sites: one per W8A8_BLOCK_SITES."""
    return -(-n // W8A8_BLOCK_SITES)


def w8a8_staged_bytes(n: int, *, nf: int, modes: int, depth: int,
                      int_requant: bool) -> int:
    """Shared-memory bytes one K11 launch stages: per block and mode the
    int8 hidden layers and output head, w1 and b1 (bf16), c6 and b6
    (float) and the requant constants (4 words per column for "int", 2
    for "f32")."""
    per_mode = (depth * nf * nf + 64 * nf + 2 * 5 * nf + 4 * 2 * 64
                + depth * nf * (4 if int_requant else 2) * 4)
    return w8a8_grid(n) * modes * per_mode


def _w8a8_geometry(uk, st, n):
    """One K11 call's launch geometry: grid, site tile, dynamic shared
    memory (`unit_kernel.w8a8_smem_bytes`) and the weight bytes staged into
    it per call."""
    M, nf, _ = st["w1t"].shape
    D, intq = st["hwqt"].shape[0], "hmq" in st
    staged = w8a8_staged_bytes(n, nf=nf, modes=M, depth=D, int_requant=intq)
    smem, every = uk.w8a8_smem_bytes(nf, D, intq, M)
    how = "all modes staged at once" if every else "one mode at a time"
    return (f"grid={w8a8_grid(n)} x {128 * W8A8_GROUPS[nf]} threads, site "
            f"tile {W8A8_TILE} per warpgroup ({W8A8_BLOCK_SITES} sites per "
            f"block), dynamic smem {smem} B ({how}), staged_bytes={staged}")


def _reset(*counters):
    for c in counters:
        for k in c:
            c[k] = 0


def _only(counter, name, count):
    """The launch counts of a run that launched only `name`, `count`
    times."""
    return {k: count if k == name else 0 for k in counter}


def _differ(torch, got, want, mix=None):
    """|diff| of a kernel output against its plain version, in output
    units (greylevels for the inner mix), as a float tensor."""
    if got.dtype == torch.int32:
        g, w = got.view(torch.uint8).float(), want.view(torch.uint8).float()
    else:
        g, w = got.float(), want.float()
        if mix == "inner":
            g, w = torch.round(g * 255), torch.round(w * 255)
    return (g - w).abs()


def _gate(what, d, max_abs, max_frac=ACC_FRAC):
    """Share of differing entries and max |diff| against their gates, with
    the count of entries by |diff|; returns the max."""
    frac, err = (d > 0).float().mean().item(), d.max().item()
    hist = {k: int((d == k).sum()) for k in range(1, int(err) + 1)}
    print(f"{what}: {frac:.3e} of {d.numel()} entries differ (gate "
          f"{max_frac:g}), max |diff| {err:g} (gate {max_abs:g}), "
          f"count by |diff| {hist}")
    if frac > max_frac or err > max_abs:
        raise RuntimeError(f"{what} misses its gate")
    return err


def _u8_gate(what, got, ref, equal=U8_EQUAL):
    """uint8 images against each other: the shares of bytes equal (gate
    `equal`) and within 2 and the max |diff| against their gates."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise RuntimeError(f"{what}: {got.shape} {got.dtype} vs {ref.shape} "
                           f"{ref.dtype}")
    d = np.abs(got.astype(np.int64) - ref)
    eq, near = float((d == 0).mean()), float((d <= 2).mean())
    hist = {k: int((d == k).sum()) for k in range(1, int(d.max()) + 1)}
    print(f"{what}: {eq:.6f} of {d.size} "
          f"bytes equal (gate {equal}), {near:.6f} within 2 (gate "
          f"{U8_NEAR}), max |diff| {int(d.max())} (gate {U8_ABS}), count by "
          f"|diff| {hist}")
    if eq < equal or near < U8_NEAR or d.max() > U8_ABS:
        raise RuntimeError(f"{what} misses its gate")


def _plain_work(st_t, n, src_bytes, v, mix):
    """(useful flops, bytes) of one plain stage-ensemble call over n image
    sites: per site and pass the K=4 head, the depth nf x nf layers and v
    output lanes; the tap source and the weights read once, each site's
    output written once."""
    D, M, nf, _ = st_t["hwt"].shape
    flops = n * 4 * M * (2 * nf * 4 + 2 * D * nf * nf + 2 * nf * v)
    out_bytes = {"inner": 2, "final_pack": 16, "final_u8": 32}.get(mix, 64)
    w_bytes = sum(t.numel() * 2 for t in st_t.values())
    return flops, src_bytes + w_bytes + n * out_bytes


def _k3_work(st_t, plane, kw):
    """(image sites, useful flops, bytes) of one window-kernel call on an
    image of H rows (`_plain_work`; the plane's pad band, computed and
    cropped, does not count)."""
    from mulut_tpu_torch.ops.unit_kernel import window_offsets

    P, _ = window_offsets(kw["modes"])
    Wp, Hp = kw["width"], H + 2 * P
    bc, rest = divmod(plane.shape[0], Hp * Wp)
    if rest:
        raise RuntimeError(f"plane of {plane.shape[0]} is not B*C x {Hp} x "
                           f"{Wp}")
    n = bc * H * (Wp - 2 * P)
    return (n, *_plain_work(st_t, n, plane.shape[0] * 2, kw.get("v") or 16,
                            kw.get("mix")))


def _k4_work(st_t, taps, kw):
    """As `_k3_work` for one dense-kernel call: every tap-matrix row is an
    image site."""
    n = taps.shape[0]
    return (n, *_dense_work(st_t, n, taps.numel() * 2, kw.get("v") or 16,
                            None))


def _chain_ms(torch, n, M, nf, v, dense, depth):
    """The same layer chain as cuBLAS bf16 matmuls (rotations stacked,
    4n rows per mode; f32 tanh/round/accumulate): a yardstick of what a
    library does with the shapes, never called by the port."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return (torch.rand(shape, generator=g, device=dev) - 0.5).to(bf)

    t, w1, b1 = rnd(4 * n, 4), rnd(4, nf), rnd(nf)
    ks = [nf * (l + 1) for l in range(4)] if dense else [nf] * depth
    ws, bs = [rnd(k, nf) for k in ks], [rnd(nf) for _ in ks]
    w6 = rnd(5 * nf if dense else nf, v)

    def run():
        acc = torch.zeros((n, v), device=dev)
        for _ in range(M):
            x = torch.relu(t @ w1 + b1)
            for w, b in zip(ws, bs):
                y = torch.relu(x @ w + b)
                x = torch.cat([x, y], dim=1) if dense else y
            o = torch.tanh((x @ w6).float()).view(4, n, v)
            acc += torch.round(o * 127).sum(0)
        return acc

    ms = _cuda_ms(torch, run, 2)
    del t, ws
    torch.cuda.empty_cache()
    return ms


def _net_mode(torch, tk, imgs):
    """Phases 7-9; returns the K3 and K4 entries of the kernels line."""
    from mulut_tpu_torch.models import srnet as sn
    from mulut_tpu_torch.models.torch_import import load_params_npz
    from mulut_tpu_torch.ops import unit_kernel as uk
    from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

    cfg = dict(stages=STAGES, modes=MODES, scale=SCALE)
    counters = (tk.LAUNCHES, uk.LAUNCHES)
    crop = np.ascontiguousarray(imgs[0, :CROP_H, :CROP_W])
    mpix = BATCH * H * SCALE * W * SCALE / 1e6
    entries = {}
    for arch in ("plain", "dense"):
        # 7 / 8. the evaluator, its kernels against their plain versions
        if arch == "plain":
            params = load_params_npz(NET_WEIGHTS)
            name, wrapper = "stage_ensemble_apply_w", uk.stage_ensemble_apply_w
        else:
            params = sn.init_srnets(np.random.default_rng(0), nf=64,
                                    arch="dense", **cfg)
            name, wrapper = "stage_ensemble_apply", uk.stage_ensemble_apply
        plain_fn = getattr(uk, name + "_plain")
        t0 = time.perf_counter()
        ev = NetEvaluator(params, fast=True, **cfg)
        torch.cuda.synchronize()
        print(f"net {arch}: NetEvaluator(fast=True) built in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms; stage stacks "
              + ", ".join(f"{k}{tuple(v.shape)}" for k, v in
                          ev.stacked[1].items()))

        def both():
            ev.upscale_batch(imgs)
            if arch == "plain":
                ev.upscale_yuv_batch(imgs)

        k3, k4 = _record_calls(
            uk, ("stage_ensemble_apply_w", "stage_ensemble_apply"), both)
        calls = [(*args, kw) for args, kw in (k3 if arch == "plain" else k4)]
        want_n = 4 if arch == "plain" else 2
        if len(calls) != want_n or len(k3) + len(k4) != want_n:
            raise RuntimeError(f"net {arch}: recorded {len(k3)} K3 and "
                               f"{len(k4)} K4 calls; expected {want_n} {name}")
        sites = (["rgb s1 inner", "rgb s2 final", "yuv s1 inner",
                  "yuv s2 final_pack"] if arch == "plain"
                 else ["rgb s1", "rgb s2"])
        err = 0.0
        for site, (st, x, kw) in zip(sites, calls):
            kinds = [None] + ([kw["mix"]] if kw.get("mix") else [])
            for mix in kinds:
                kwm = dict(kw, mix=mix) if arch == "plain" else kw
                got = wrapper(st, x, **kwm)
                pkw = {k: v_ for k, v_ in kwm.items() if k != "v"}
                want = plain_fn(st, x, **pkw)
                torch.cuda.synchronize()
                err = max(err, _gate(
                    f"K{3 if arch == 'plain' else 4} {site} "
                    f"{'raw acc' if mix is None else mix} "
                    f"{tuple(got.shape)}", _differ(torch, got, want, mix),
                    RAW_ABS if mix is None else MIX_ABS))
        # the main path through the entry points, counted
        _reset(*counters)
        t0 = time.perf_counter()
        out = ev.upscale_batch(imgs)
        first_s = time.perf_counter() - t0
        launches = dict(uk.LAUNCHES)
        print(f"net {arch} upscale_batch: {imgs.shape} -> {out.shape}, "
              f"launches {launches} + LUT {dict(tk.LAUNCHES)}")
        if launches[name] != 2 or sum(launches.values()) != 2 \
                or any(tk.LAUNCHES.values()):
            raise RuntimeError(f"net {arch} upscale_batch launches "
                               f"{launches}; expected 2 {name}")
        if out.shape != (BATCH, H * SCALE, W * SCALE, 3) or \
                out.dtype != np.uint8:
            raise RuntimeError(f"bad output {out.shape} {out.dtype}")
        entries[arch] = {"launches": launches[name], "err": err}
        if arch == "plain":
            _reset(*counters)
            yuv = ev.upscale_yuv_batch(imgs)
            print(f"net plain upscale_yuv_batch: -> {yuv.shape}, launches "
                  f"{dict(uk.LAUNCHES)}")
            if dict(uk.LAUNCHES) != _only(uk.LAUNCHES, name, 2):
                raise RuntimeError("upscale_yuv_batch: expected 2 K3 "
                                   "launches")
            if yuv.shape != out.shape or yuv.dtype != np.uint8:
                raise RuntimeError(f"bad YUV output {yuv.shape}")
        # the card against the CPU path on a crop of frame 0
        t0 = time.perf_counter()
        ev_cpu = NetEvaluator(params, fast=True, device="cpu", **cfg)
        _u8_gate(f"net {arch} {CROP_H}x{CROP_W} crop, card vs CPU path",
                 ev.upscale(crop), ev_cpu.upscale(crop))
        if arch == "plain":
            _u8_gate(f"net plain {CROP_H}x{CROP_W} crop YUV, card vs CPU",
                     ev.upscale_yuv(crop), ev_cpu.upscale_yuv(crop))
        print(f"net {arch} CPU path: {time.perf_counter() - t0:.1f} s")

        # 9. timings
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            ev.upscale_batch(imgs)
        batch_ms = (time.perf_counter() - t0) * 1e3 / reps
        x = torch.from_numpy(imgs).cuda().permute(0, 3, 1, 2).float() / 255

        def forward():
            return sn.srnets_predict_fast(ev.stacked, x, **cfg)

        dev_ms = _cuda_ms(torch, forward, reps)
        print(f"net {arch} upscale_batch (host clock, H2D + D2H included): "
              f"{batch_ms:.3f} ms/batch = {mpix / batch_ms * 1e3:.2f} MPix/s "
              f"(first call {first_s * 1e3:.1f} ms)")
        print(f"net {arch} srnets_predict_fast on the card (CUDA events): "
              f"{dev_ms:.3f} ms/batch = {mpix / dev_ms * 1e3:.2f} MPix/s")
        if arch == "plain":
            t0 = time.perf_counter()
            for _ in range(reps):
                ev.upscale_yuv_batch(imgs)
            yuv_ms = (time.perf_counter() - t0) * 1e3 / reps
            print(f"net plain upscale_yuv_batch (host clock): {yuv_ms:.3f} "
                  f"ms/batch = {mpix / yuv_ms * 1e3:.2f} MPix/s")
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
        work = _k3_work if arch == "plain" else _k4_work
        for site, (st, xin, kw) in zip(sites, calls):
            n, flops, nbytes = work(st, xin, kw)
            pkw = {k: v_ for k, v_ in kw.items() if k != "v"}
            t = {
                "ms": _cuda_ms(torch, lambda: wrapper(st, xin, **kw), 10),
                "plain_ms": _cuda_ms(torch, lambda: plain_fn(st, xin, **pkw),
                                     2),
                "bound_ms": max(flops / BF16_FLOPS_PER_MS,
                                nbytes / HBM_BYTES_PER_MS),
            }
            if arch == "plain":
                D, M, nf, _ = st["hwt"].shape
                rows, dense = xin.shape[0], False
            else:
                M, nf, _ = st["w1t"].shape
                rows, D, dense = xin.shape[0], 4, True
            t["cublas_chain_ms"] = _chain_ms(torch, rows, M, nf, kw.get("v"),
                                             dense, D)
            print(f"K{3 if arch == 'plain' else 4} {site}: image sites={n} "
                  f"kernel rows={rows} "
                  f"flops={flops:.4e} bytes={nbytes} "
                  + " ".join(f"{k}={v_:.4f}" for k, v_ in t.items()))
            if dense:
                print(f"K4 {site} geometry: " + _dense_geometry(
                    torch, rows, modes=M, v=kw.get("v") or 16,
                    unit=False))
            else:
                print(f"K3 {site} geometry: " + _plain_geometry(
                    rows, modes=M, depth=D, head="mxu"))
            if site.startswith("rgb"):
                for k in tot:
                    tot[k] += t[k]
        entries[arch].update(tot)
        if arch == "plain":
            _profile(torch, forward, dev_ms)
        del ev, ev_cpu, k3, k4, calls, x
        torch.cuda.empty_cache()

    def entry(arch, kname, src, rep):
        e = entries[arch]
        return {"name": kname, "route": "cuda", "source": src,
                "replaces": rep, "launches": e["launches"],
                "max_abs_err": e["err"], "ms": e["ms"],
                "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                "bound_by": "operations", "library_ms": None}

    return [entry("plain", "stage_ensemble_apply_w", SOURCE_K3, REPLACES_K3),
            entry("dense", "stage_ensemble_apply", SOURCE_K4, REPLACES_K4)]


def _k11_work(st, taps, kw):
    """(image sites, useful int8 ops, bytes) of one K11 call: per site and
    pass the K=4 head, the depth nf x nf layers and v output lanes; the tap
    matrix and the weights read once, the (N, 16) float32 output written
    once."""
    M, nf, _ = st["w1t"].shape
    D = st["hwqt"].shape[0]
    n, v = taps.shape[0], kw.get("v") or 16
    ops = n * 4 * M * (2 * nf * 4 + 2 * D * nf * nf + 2 * nf * v)
    w_bytes = sum(t.numel() * t.element_size() for t in st.values())
    return n, ops, taps.numel() * 2 + w_bytes + n * 16 * 4


def _int8_chain_ms(torch, st, n, v, int_requant):
    """The same per-stage work as library calls: per pass a bf16 head,
    its int8 codes, `torch._int_mm` for each hidden layer and the output
    head, the requant and the tanh epilogue as torch elementwise steps, on
    n rows of random taps with this stack's weights.  A yardstick only,
    never called by the port."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    M, D = st["w1t"].shape[0], st["hwqt"].shape[0]
    t = torch.rand((n, 4), generator=g, device=dev).to(torch.bfloat16)
    # _int_mm wants its second operand column-major: [out][in] transposed
    ws = [[st["hwqt"][d, mi].t() for d in range(D)] for mi in range(M)]
    w6 = [[st["w6qt"][mi, 16 * r: 16 * r + 16].t() for r in range(4)]
          for mi in range(M)]

    def requant(a, d, mi):
        if int_requant:
            ti = (a * st["hmq"][d, mi] + st["hhq"][d, mi]) >> st["hsq"][d, mi]
            return torch.clamp(ti + st["hbi"][d, mi], 0, 127).to(torch.int8)
        y = torch.addcmul(st["hbq"][d, mi], a.float(), st["hcq"][d, mi])
        return torch.clamp(torch.round(torch.relu(y)), 0, 127).to(torch.int8)

    def run():
        acc = torch.zeros((n, v), device=dev)
        for mi in range(M):
            for r in range(4):
                x = torch.relu(t @ st["w1t"][mi].t() + st["b1"][mi])
                xq = torch.clamp(torch.round(x.float()), 0, 127).to(torch.int8)
                for d in range(D):
                    xq = requant(torch._int_mm(xq, ws[mi][d]), d, mi)
                sl = slice(16 * r, 16 * r + v)
                o = torch._int_mm(xq, w6[mi][r])[:, :v].float()
                o = torch.addcmul(st["b6"][mi, sl], o, st["c6"][mi, sl])
                acc += torch.round(torch.tanh(o) * 127)
        return acc

    ms = _cuda_ms(torch, run, 2)
    del t
    torch.cuda.empty_cache()
    return ms


def _w8a8_ragged(torch, uk, stacks):
    """K11 at ragged site counts, which the batch never reaches: each of
    `stacks` ({name: (stage-1 stack, stage-2 stack)}) on random bf16 taps
    in [0, 1) at n = 1, 63, 65, one block's sites -1 and +1 and 1,000,003,
    against its plain version on the same taps; no entry may differ (K11
    is exact, so small n gets no reading exception)."""
    g = torch.Generator(device="cuda").manual_seed(9)
    M, N = len(MODES), 1_000_003
    taps = torch.rand((N, 16 * M), generator=g, device="cuda").to(
        torch.bfloat16)
    sizes = (1, 63, 65, W8A8_BLOCK_SITES - 1, W8A8_BLOCK_SITES + 1, N)
    for name, pair in stacks.items():
        for s, (st, v) in enumerate(zip(pair, (1, 16))):
            for n in sizes:
                tn = taps[:n].contiguous()
                got = uk.stage_ensemble_apply_q(st, tn, n_modes=M, v=v)
                want = uk.stage_ensemble_apply_q_plain(st, tn, n_modes=M)
                torch.cuda.synchronize()
                _gate(f"ragged K11 {name} n={n} s{s + 1} raw acc vs plain",
                      _differ(torch, got, want), 0, max_frac=0)


def _quant_mode(torch, tk, imgs):
    """Phase 10; returns K11's entry of the kernels line (nf=128, "int")."""
    from mulut_tpu_torch.models import srnet as sn
    from mulut_tpu_torch.ops import unit_kernel as uk
    from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

    cfg = dict(stages=STAGES, modes=MODES, scale=SCALE)
    counters = (tk.LAUNCHES, uk.LAUNCHES)
    crop = np.ascontiguousarray(imgs[0, :CROP_H, :CROP_W])
    mpix = BATCH * H * SCALE * W * SCALE / 1e6
    sites = ["rgb s1", "rgb s2", "yuv s1", "yuv s2"]
    want_launches = _only(uk.LAUNCHES, "stage_ensemble_apply_q", 2)
    entry, stacks = None, {}
    for weights in (NET_WEIGHTS, NET_WEIGHTS_NF256):
        for quant in (True, "f32"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev = NetEvaluator.from_checkpoint(weights, quant=quant, **cfg)
            torch.cuda.synchronize()
            nf = ev.stacked[0]["w1t"].shape[1]
            tag = f"nf={nf} {quant!r}"
            wide = nf > 128
            print(f"quant {tag}: NetEvaluator.from_checkpoint({weights}) "
                  "with W8A8 quantization in "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms; stage stacks "
                  + ", ".join(f"{k}{tuple(v.shape)} {str(v.dtype)[6:]}"
                              for k, v in ev.stacked[1].items()))

            def both():
                ev.upscale_batch(imgs)
                ev.upscale_yuv_batch(imgs)

            (calls,) = _record_calls(uk, ("stage_ensemble_apply_q",), both)
            if len(calls) != len(sites):
                raise RuntimeError(f"quant {tag}: recorded {len(calls)} K11 "
                                   f"calls; expected {len(sites)}")
            err = 0.0
            for site, ((st, taps), kw) in zip(sites, calls):
                got = uk.stage_ensemble_apply_q(st, taps, **kw)
                want = uk.stage_ensemble_apply_q_plain(
                    st, taps, n_modes=kw["n_modes"])
                torch.cuda.synchronize()
                # no entry may differ: the int8 sums are exact, and the
                # bf16 head, requant and dequantizing FMAs round as the
                # plain version does, with the same card's tanhf (NVIDIA
                # H100 80GB HBM3, this batch: 0 of 66.4 M entries, per
                # stage and form)
                err = max(err, _gate(
                    f"K11 {tag} {site} raw acc {tuple(got.shape)}",
                    _differ(torch, got, want), 0, max_frac=0))
                print(f"K11 {tag} {site} geometry: "
                      + _w8a8_geometry(uk, st, taps.shape[0]))
            # the main path through the entry points, counted
            for fn in (ev.upscale_batch, ev.upscale_yuv_batch):
                _reset(*counters)
                out = fn(imgs)
                launches = dict(uk.LAUNCHES)
                if fn == ev.upscale_batch:
                    k11_launches = launches["stage_ensemble_apply_q"]
                print(f"quant {tag} {fn.__name__}: {imgs.shape} -> "
                      f"{out.shape}, launches {launches} + LUT "
                      f"{dict(tk.LAUNCHES)}")
                if launches != want_launches or any(tk.LAUNCHES.values()):
                    raise RuntimeError(f"quant {tag} {fn.__name__} launches "
                                       f"{launches}; expected "
                                       f"{want_launches}")
                if out.shape != (BATCH, H * SCALE, W * SCALE, 3) or \
                        out.dtype != np.uint8:
                    raise RuntimeError(f"bad output {out.shape} {out.dtype}")
            # the card against the CPU path on a crop of frame 0 (nf=256:
            # RGB only, its CPU path is 4x as slow)
            t0 = time.perf_counter()
            ev_cpu = NetEvaluator.from_checkpoint(weights, quant=quant,
                                                  device="cpu", **cfg)
            _u8_gate(f"quant {tag} {CROP_H}x{CROP_W} crop, card vs CPU path",
                     ev.upscale(crop), ev_cpu.upscale(crop))
            if not wide:
                _u8_gate(f"quant {tag} {CROP_H}x{CROP_W} crop YUV, card vs "
                         "CPU", ev.upscale_yuv(crop), ev_cpu.upscale_yuv(crop))
            print(f"quant {tag} CPU path: {time.perf_counter() - t0:.1f} s")

            # timings
            reps = 5
            t0 = time.perf_counter()
            for _ in range(reps):
                ev.upscale_batch(imgs)
            batch_ms = (time.perf_counter() - t0) * 1e3 / reps
            t0 = time.perf_counter()
            for _ in range(reps):
                ev.upscale_yuv_batch(imgs)
            yuv_ms = (time.perf_counter() - t0) * 1e3 / reps
            x = torch.from_numpy(imgs).cuda().permute(0, 3, 1, 2).float() / 255
            dev_ms = _cuda_ms(torch, lambda: sn.srnets_predict_fast(
                ev.stacked, x, **cfg), reps)
            print(f"quant {tag} upscale_batch (host clock, H2D + D2H "
                  f"included): {batch_ms:.3f} ms/batch = "
                  f"{mpix / batch_ms * 1e3:.2f} MPix/s")
            print(f"quant {tag} srnets_predict_fast on the card (CUDA "
                  f"events): {dev_ms:.3f} ms/batch = "
                  f"{mpix / dev_ms * 1e3:.2f} MPix/s")
            print(f"quant {tag} upscale_yuv_batch (host clock): "
                  f"{yuv_ms:.3f} ms/batch = {mpix / yuv_ms * 1e3:.2f} MPix/s")
            tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
            chain = {}
            for site, ((st, taps), kw) in zip(sites, calls):
                if wide and not site.startswith("rgb"):
                    continue
                n, ops, nbytes = _k11_work(st, taps, kw)
                t = {
                    "ms": _cuda_ms(torch, lambda: uk.stage_ensemble_apply_q(
                        st, taps, **kw), 10),
                    "plain_ms": _cuda_ms(torch, lambda: (
                        uk.stage_ensemble_apply_q_plain(
                            st, taps, n_modes=kw["n_modes"])), 1 if wide
                        else 2),
                    "bound_ms": max(ops / INT8_OPS_PER_MS,
                                    nbytes / HBM_BYTES_PER_MS),
                }
                v = kw.get("v") or 16
                if (n, v) not in chain:
                    chain[n, v] = _int8_chain_ms(torch, st, n, v,
                                                 "hmq" in st)
                t["int8_chain_ms"] = chain[n, v]
                print(f"K11 {tag} {site}: image sites={n} ops={ops:.4e} "
                      f"bytes={nbytes} "
                      + " ".join(f"{k}={v_:.4f}" for k, v_ in t.items()))
                if site.startswith("rgb"):
                    for k in tot:
                        tot[k] += t[k]
            print(f"K11 {tag} per batch (rgb s1 + s2): "
                  + " ".join(f"{k}={v_:.4f}" for k, v_ in tot.items()))
            if quant is True and not wide:
                entry = {"name": "stage_ensemble_apply_q", "route": "cuda",
                         "source": SOURCE_K11, "replaces": REPLACES_K11,
                         "launches": k11_launches, "max_abs_err": err,
                         "ms": tot["ms"],
                         "plain_ms": tot["plain_ms"],
                         "bound_ms": tot["bound_ms"],
                         "bound_by": "operations", "library_ms": None}
            stacks[tag] = ev.stacked
            del ev, ev_cpu, calls, x
            torch.cuda.empty_cache()
    _w8a8_ragged(torch, uk, stacks)
    return entry


#: Phase 11's dense routes: kernel, launch key, the wrapper that reaches
#: it, the module flags and environment that select it, source, and the
#: JAX body it replaces.
DENSE_ROUTES = (
    ("K5", "stage_ensemble_apply_w_dense", "stage_ensemble_apply_w",
     "feature", True, False, SOURCE_K5, REPLACES_K5),
    ("K7", "stage_ensemble_apply_t", "stage_ensemble_apply_t",
     "feature", False, False, SOURCE_K7, REPLACES_K7),
    ("K9", "stage_ensemble_apply_pair", "stage_ensemble_apply",
     "site", True, True, SOURCE_K9, REPLACES_K9),
)


@contextlib.contextmanager
def _route_flags(sn, layout, window, paired):
    """`models.srnet`'s DENSE_LAYOUT and PLAIN_WINDOW (read at each
    forward) and MULUT_PAIRED_KERNEL (read when an evaluator is built),
    restored on exit."""
    old = sn.DENSE_LAYOUT, sn.PLAIN_WINDOW, os.environ.get(
        "MULUT_PAIRED_KERNEL")
    sn.DENSE_LAYOUT, sn.PLAIN_WINDOW = layout, window
    os.environ["MULUT_PAIRED_KERNEL"] = "1" if paired else "0"
    try:
        yield
    finally:
        sn.DENSE_LAYOUT, sn.PLAIN_WINDOW = old[:2]
        if old[2] is None:
            os.environ.pop("MULUT_PAIRED_KERNEL")
        else:
            os.environ["MULUT_PAIRED_KERNEL"] = old[2]


def _dense_work(st_t, n, src_bytes, v, mix):
    """(useful flops, bytes) of one dense stage-ensemble call over n image
    sites (a window call's pad band, computed and cropped, does not count):
    per site and pass the K=4 head, the concat layers and v output lanes;
    the tap source and the weights read once, each site's output written
    once."""
    M, nf = st_t["w1t"].shape[:2]
    flops = n * 4 * M * (2 * nf * 4 + 2 * nf * nf * (1 + 2 + 3 + 4)
                         + 2 * 5 * nf * v)
    w_bytes = sum(t.numel() * 2 for t in st_t.values())
    out_bytes = {"inner": 2, "final_pack": 16, "final_u8": 32}.get(mix, 64)
    return flops, src_bytes + w_bytes + n * out_bytes


def _same(what, got, ref):
    """A ragged launch against the same sites of another launch: no entry
    may differ."""
    d = int((got != ref).sum())
    print(f"ragged {what}: {d} of {got.numel()} entries differ")
    if got.shape != ref.shape or d:
        raise RuntimeError(f"ragged {what} differs")


def _reading(torch, what, got, want, scale=1, site_dim=0):
    """A launch against its plain version, printed, not gated: at n <= 769
    one tie flip is already 1e-3 of the entries, so the share gate is held
    at n = 1,000,003 only (ROADMAP Queue C).  The count of sites (index
    `site_dim`) with a differing entry beside it: a site's lanes share its
    hidden activations, so its flips come together."""
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs() * scale
    nz = torch.nonzero(d > 0)
    first = ""
    if len(nz):
        i = tuple(nz[0].tolist())
        first = (f", first at {i}: {got[i].item():g} against "
                 f"{want[i].item():g}")
    sites = torch.unique(nz[:, site_dim]).numel()
    print(f"{what} vs plain (reading): {len(nz)} of {d.numel()} "
          f"entries in {sites} of {got.shape[site_dim]} sites differ, "
          f"max |diff| {d.max().item():g}{first}")


def _dense_ragged(torch, uk, stacks, params):
    """Each dense entry (K4, K9, K7, K5 on both stages' stacks; K10 on a
    stage-1 and a stage-2 unit) at ragged site counts, which the batch (a
    multiple of 64) never reaches: n = 1,000,003 against its plain version
    (the per-call gates), and n = 1, 63, 65 and one block's sites -1 and
    +1 equal, with no entry differing, to the same sites of a launch whose
    ragged edge lies elsewhere: the first n sites of the n = 1,000,003
    launch (a site's output depends on its own taps only), for K5 the
    plane of n sites zero-extended past its last tap (taps past n read
    0).  K9's and K7's raw accumulators against K4's: no entry differs.
    Each small launch is also held against its plain version as a printed
    reading (count, max |diff|, first differing entry): a tie flip there
    is a real rate, not a fault (ROADMAP Queue C)."""
    from mulut_tpu_torch.models.torch_import import params_from_numpy

    g = torch.Generator(device="cuda").manual_seed(7)
    M, T, N = len(MODES), DENSE_BLOCK_SITES, 1_000_003
    P, _ = uk.window_offsets(MODES)
    Wp = W + 2 * P
    units = {k: {n: t.to(torch.bfloat16) for n, t in u.items()}
             for k, u in params_from_numpy(params, "cuda").items()
             if k in ("s1_s", "s2_y")}

    def rnd(*shape):
        return torch.rand(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    sizes = (1, 63, 65, T - 1, T + 1)
    for s, (st, v) in enumerate(zip(stacks, (1, 16))):
        taps, plane = rnd(N, 16 * M), rnd(N)
        tt = taps.T.contiguous()
        pst = uk.pair_stage_params(st)
        k4 = uk.stage_ensemble_apply(st, taps, n_modes=M, v=v)
        want = uk.stage_ensemble_apply_plain(st, taps, n_modes=M)
        torch.cuda.synchronize()
        _gate(f"ragged K4 n={N} s{s + 1} raw acc vs plain",
              _differ(torch, k4, want), RAW_ABS)
        _same(f"K9 n={N} s{s + 1} raw acc vs K4",
              uk.stage_ensemble_apply(pst, taps, n_modes=M, v=v), k4)
        k7 = uk.stage_ensemble_apply_t(st, tt, n_modes=M, v=v)
        want = uk.stage_ensemble_apply_t_plain(st, tt, n_modes=M)
        torch.cuda.synchronize()
        _gate(f"ragged K7 n={N} s{s + 1} raw acc vs plain",
              _differ(torch, k7, want), RAW_ABS)
        _same(f"K7 n={N} s{s + 1} raw acc vs K4", k7.T, k4)
        k5 = uk.stage_ensemble_apply_w(st, plane, modes=MODES, width=Wp, v=v)
        want = uk.stage_ensemble_apply_w_plain(st, plane, modes=MODES,
                                               width=Wp)
        torch.cuda.synchronize()
        _gate(f"ragged K5 n={N} s{s + 1} raw acc vs plain",
              _differ(torch, k5, want), RAW_ABS)
        for n in sizes:
            what = f"n={n} s{s + 1}"
            tn, ttn, pn = (taps[:n].contiguous(), tt[:, :n].contiguous(),
                           plane[:n].contiguous())
            got = uk.stage_ensemble_apply(st, tn, n_modes=M, v=v)
            _same(f"K4 {what} vs the n={N} launch", got, k4[:n])
            _reading(torch, f"ragged K4 {what}", got,
                     uk.stage_ensemble_apply_plain(st, tn, n_modes=M))
            got = uk.stage_ensemble_apply(pst, tn, n_modes=M, v=v)
            _same(f"K9 {what} vs the n={N} launch", got, k4[:n])
            _reading(torch, f"ragged K9 {what}", got,
                     uk.stage_ensemble_apply_plain(pst, tn, n_modes=M))
            got = uk.stage_ensemble_apply_t(st, ttn, n_modes=M, v=v)
            _same(f"K7 {what} vs the n={N} launch", got, k4[:n].T)
            _reading(torch, f"ragged K7 {what}", got,
                     uk.stage_ensemble_apply_t_plain(st, ttn, n_modes=M),
                     site_dim=1)
            ext = torch.cat([plane[:n], torch.zeros(
                (P + 1) * (Wp + 1) + 64, dtype=plane.dtype,
                device=plane.device)])
            got = uk.stage_ensemble_apply_w(st, pn, modes=MODES, width=Wp,
                                            v=v)
            _same(f"K5 {what} vs its plane zero-extended", got,
                  uk.stage_ensemble_apply_w(st, ext, modes=MODES, width=Wp,
                                            v=v)[:, :n])
            _reading(torch, f"ragged K5 {what}", got,
                     uk.stage_ensemble_apply_w_plain(st, pn, modes=MODES,
                                                     width=Wp), site_dim=1)
    taps = rnd(N, 4)
    for key, pu in units.items():
        od = pu["w6"].shape[1]
        big = uk.fused_unit_apply(pu, taps, out_dim=od)
        want = uk.fused_unit_apply_plain(pu, taps, out_dim=od)
        torch.cuda.synchronize()
        _gate(f"ragged K10 n={N} {key} (out {od}) vs plain, x127",
              (big.float() - want.float()).abs() * 127, K10_ABS)
        for n in sizes:
            tn = taps[:n].contiguous()
            got = uk.fused_unit_apply(pu, tn, out_dim=od)
            _same(f"K10 n={n} {key} vs the n={N} launch", got, big[:n])
            _reading(torch, f"ragged K10 n={n} {key}, x127", got,
                     uk.fused_unit_apply_plain(pu, tn, out_dim=od), 127)


def _dense_routes(torch, tk, imgs):
    """Phase 11; returns the K5, K7, K9 and K10 entries of the kernels
    line."""
    from mulut_tpu_torch.models import srnet as sn
    from mulut_tpu_torch.models.torch_import import params_from_numpy
    from mulut_tpu_torch.ops import unit_kernel as uk
    from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

    cfg = dict(stages=STAGES, modes=MODES, scale=SCALE)
    counters = (tk.LAUNCHES, uk.LAUNCHES)
    crop = np.ascontiguousarray(imgs[0, :CROP_H, :CROP_W])
    mpix = BATCH * H * SCALE * W * SCALE / 1e6
    n_img = BATCH * 3 * H * W
    P, _ = uk.window_offsets(MODES)
    params = sn.init_srnets(np.random.default_rng(0), nf=64, arch="dense",
                            **cfg)
    x = torch.from_numpy(imgs).cuda().permute(0, 3, 1, 2).float() / 255
    chain = {}

    def chain_ms(n, M, v):
        if (n, M, v) not in chain:
            chain[n, M, v] = _chain_ms(torch, n, M, 64, v, True, 4)
        return chain[n, M, v]

    # the K4 route (the default) as every route's reference
    ev4 = NetEvaluator(params, fast=True, **cfg)
    ref = ev4.upscale_batch(imgs)
    dev4_ms = _cuda_ms(torch, lambda: sn.srnets_predict_fast(
        ev4.stacked, x, **cfg), 5)
    print(f"dense K4 route srnets_predict_fast on the card (CUDA events): "
          f"{dev4_ms:.3f} ms/batch")
    _dense_ragged(torch, uk, ev4.stacked, params)
    entries = []
    for (kn, key, wname, layout, window, paired, src,
         rep) in DENSE_ROUTES:
        wrapper = getattr(uk, wname)
        plain_fn = getattr(uk, wname + "_plain")
        with _route_flags(sn, layout, window, paired):
            ev = NetEvaluator(params, fast=True, **cfg)
            (calls,) = _record_calls(uk, (wname,),
                                     lambda: ev.upscale_batch(imgs))
            if len(calls) != 2:
                raise RuntimeError(f"{kn}: recorded {len(calls)} {wname} "
                                   "calls; expected 2")
            err = 0.0
            for s, ((st, src_t), kw) in enumerate(calls):
                mix = kw.get("mix")
                for kind in [None] + ([mix] if mix else []):
                    kwm = dict(kw, mix=kind) if "mix" in kw else kw
                    got = wrapper(st, src_t, **kwm)
                    want = plain_fn(st, src_t, **{
                        k: v_ for k, v_ in kwm.items() if k != "v"})
                    torch.cuda.synchronize()
                    err = max(err, _gate(
                        f"{kn} s{s + 1} {'raw acc' if kind is None else kind}"
                        f" {tuple(got.shape)} vs plain",
                        _differ(torch, got, want, kind),
                        RAW_ABS if kind is None else MIX_ABS))
                    if kind is not None:
                        continue
                    # the raw accumulator against K4's on this stage's
                    # input: one pass body, so no entry may differ
                    if kn == "K5":
                        Wp = kw["width"]
                        Hp = src_t.numel() // (BATCH * 3 * Wp)
                        img = src_t.view(BATCH, 3, Hp, Wp)[
                            :, :, P: Hp - P, P: Wp - P]
                        taps = sn._ensemble_taps(img, MODES)
                        raw = got.view(16, BATCH, 3, Hp, Wp)[
                            ..., P: Hp - P, P: Wp - P].reshape(16, -1).T
                    elif kn == "K7":
                        taps, raw = src_t.T.contiguous(), got.T
                    else:
                        taps, raw = src_t, got
                    k4 = uk.stage_ensemble_apply(ev4.stacked[s], taps,
                                                 n_modes=len(MODES),
                                                 v=kw["v"])
                    _gate(f"{kn} s{s + 1} raw acc vs K4 {tuple(k4.shape)}",
                          (raw - k4).abs(), 0, max_frac=0)
            # the main path through the entry point, counted
            _reset(*counters)
            t0 = time.perf_counter()
            out = ev.upscale_batch(imgs)
            first_s = time.perf_counter() - t0
            launches = dict(uk.LAUNCHES)
            print(f"{kn} route upscale_batch: {imgs.shape} -> {out.shape}, "
                  f"launches {launches} + LUT {dict(tk.LAUNCHES)}")
            if launches != _only(uk.LAUNCHES, key, 2) or any(
                    tk.LAUNCHES.values()):
                raise RuntimeError(f"{kn} route launches {launches}; "
                                   f"expected 2 {key}")
            n_diff = int((out != ref).sum())
            print(f"{kn} route upscale_batch vs the K4 route: {n_diff} of "
                  f"{out.size} bytes differ")
            if out.shape != ref.shape or n_diff:
                raise RuntimeError(f"{kn} route bytes differ from K4's")
            t0 = time.perf_counter()
            ev_cpu = NetEvaluator(params, fast=True, device="cpu", **cfg)
            _u8_gate(f"{kn} route {CROP_H}x{CROP_W} crop, card vs CPU path",
                     ev.upscale(crop), ev_cpu.upscale(crop))
            print(f"{kn} route CPU path: {time.perf_counter() - t0:.1f} s")
            # timings
            reps = 5
            t0 = time.perf_counter()
            for _ in range(reps):
                ev.upscale_batch(imgs)
            batch_ms = (time.perf_counter() - t0) * 1e3 / reps
            dev_ms = _cuda_ms(torch, lambda: sn.srnets_predict_fast(
                ev.stacked, x, **cfg), reps)
            print(f"{kn} route upscale_batch (host clock, H2D + D2H "
                  f"included): {batch_ms:.3f} ms/batch = "
                  f"{mpix / batch_ms * 1e3:.2f} MPix/s (first call "
                  f"{first_s * 1e3:.1f} ms)")
            print(f"{kn} route srnets_predict_fast on the card (CUDA "
                  f"events): {dev_ms:.3f} ms/batch = "
                  f"{mpix / dev_ms * 1e3:.2f} MPix/s (K4 route "
                  f"{dev4_ms:.3f})")
            tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
            for s, ((st, src_t), kw) in enumerate(calls):
                v = kw["v"]
                pkw = {k: v_ for k, v_ in kw.items() if k != "v"}
                flops, nbytes = _dense_work(
                    st, n_img, src_t.numel() * 2, v, kw.get("mix"))
                t = {
                    "ms": _cuda_ms(torch, lambda: wrapper(st, src_t, **kw),
                                   10),
                    "plain_ms": _cuda_ms(torch, lambda: plain_fn(
                        st, src_t, **pkw), 2),
                    "bound_ms": max(flops / BF16_FLOPS_PER_MS,
                                    nbytes / HBM_BYTES_PER_MS),
                    "cublas_chain_ms": chain_ms(n_img, len(MODES), v),
                }
                print(f"{kn} s{s + 1}: image sites={n_img} flops={flops:.4e} "
                      f"bytes={nbytes} "
                      + " ".join(f"{k}={v_:.4f}" for k, v_ in t.items()))
                n_src = src_t.shape[0] if kn == "K9" else src_t.shape[-1]
                print(f"{kn} s{s + 1} geometry: " + _dense_geometry(
                    torch, n_src, modes=len(MODES), v=v, unit=False))
                for k in tot:
                    tot[k] += t[k]
            entries.append({
                "name": key, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[key], "max_abs_err": err,
                "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                "bound_ms": tot["bound_ms"], "bound_by": "operations",
                "library_ms": None})
            del ev, ev_cpu, calls
            torch.cuda.empty_cache()
    del ev4
    torch.cuda.empty_cache()

    # K10: srnets_predict on bf16 params and input, unit_impl="pallas"
    def bf16_params(device):
        return {k: {n: t.to(torch.bfloat16) for n, t in u.items()}
                for k, u in params_from_numpy(params, device).items()}

    pb, xb = bf16_params("cuda"), x.to(torch.bfloat16)

    def forward():
        return sn.srnets_predict(pb, xb, unit_impl="pallas", **cfg)

    (calls,) = _record_calls(uk, ("fused_unit_apply",), forward)
    sites = [f"s{s + 1}_{m}" for s in range(STAGES) for m in MODES]
    if len(calls) != len(sites):
        raise RuntimeError(f"K10: recorded {len(calls)} fused_unit_apply "
                           f"calls; expected {len(sites)}")
    err = 0.0
    for site, ((pu, taps), kw) in zip(sites, calls):
        got = uk.fused_unit_apply(pu, taps, **kw)
        want = uk.fused_unit_apply_plain(pu, taps, **kw)
        torch.cuda.synchronize()
        # in steps of 1/127, the ensemble's rounding step
        err = max(err, _gate(f"K10 {site} {tuple(got.shape)} vs plain, "
                             "x127", (got.float() - want.float()).abs() * 127,
                             K10_ABS))
    _reset(*counters)
    out = forward()
    launches = dict(uk.LAUNCHES)
    print(f"K10 srnets_predict(unit_impl='pallas'): {tuple(xb.shape)} -> "
          f"{tuple(out.shape)} {out.dtype}, launches {launches}")
    if launches != _only(uk.LAUNCHES, "fused_unit_apply", len(sites)) or \
            any(tk.LAUNCHES.values()):
        raise RuntimeError(f"K10 launches {launches}; expected "
                           f"{len(sites)} fused_unit_apply")
    if out.shape != (BATCH, 3, H * SCALE, W * SCALE) or \
            not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"K10: bad output {tuple(out.shape)}")
    xc = torch.from_numpy(crop).permute(2, 0, 1)[None].float() / 255

    def u8(o):
        o = torch.round(torch.clamp(o.float(), 0, 255)).to(torch.uint8)
        return o[0].permute(1, 2, 0).cpu().numpy()

    t0 = time.perf_counter()
    card = sn.srnets_predict(pb, xc.cuda().to(torch.bfloat16),
                             unit_impl="pallas", **cfg)
    host = sn.srnets_predict(bf16_params("cpu"), xc.to(torch.bfloat16),
                             unit_impl="pallas", **cfg)
    _u8_gate(f"K10 {CROP_H}x{CROP_W} crop, card vs CPU path", u8(card),
             u8(host))
    print(f"K10 CPU path: {time.perf_counter() - t0:.1f} s")
    dev_ms = _cuda_ms(torch, forward, 3)
    print(f"K10 srnets_predict(unit_impl='pallas') on the card (CUDA "
          f"events): {dev_ms:.3f} ms/batch = {mpix / dev_ms * 1e3:.2f} "
          "MPix/s")
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for site, ((pu, taps), kw) in zip(sites, calls):
        rows, v, nf = taps.shape[0], kw["out_dim"], pu["w1"].shape[1]
        flops = rows * (2 * nf * 4 + 2 * nf * nf * (1 + 2 + 3 + 4)
                        + 2 * 5 * nf * v)
        nbytes = (taps.numel() * 2 + sum(t.numel() * 2 for t in pu.values())
                  + rows * v * 2)
        t = {
            "ms": _cuda_ms(torch, lambda: uk.fused_unit_apply(pu, taps, **kw),
                           10),
            "plain_ms": _cuda_ms(torch, lambda: uk.fused_unit_apply_plain(
                pu, taps, **kw), 2),
            "bound_ms": max(flops / BF16_FLOPS_PER_MS,
                            nbytes / HBM_BYTES_PER_MS),
            "cublas_chain_ms": chain_ms(rows // 4, 1, v),
        }
        print(f"K10 {site}: rows={rows} flops={flops:.4e} bytes={nbytes} "
              + " ".join(f"{k}={v_:.4f}" for k, v_ in t.items()))
        print(f"K10 {site} geometry: " + _dense_geometry(
            torch, rows, modes=1, v=max(8, -(-v // 8) * 8), unit=True))
        for k in tot:
            tot[k] += t[k]
    entries.append({
        "name": "fused_unit_apply", "route": "cuda", "source": SOURCE_K10,
        "replaces": REPLACES_K10,
        "launches": launches["fused_unit_apply"], "max_abs_err": err,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"], "bound_by": "operations",
        "library_ms": None})
    del pb, xb, calls, out, x
    torch.cuda.empty_cache()
    return entries


#: Phase 12's plain routes: kernel, launch key, the wrapper that reaches
#: it, and the flags that select it (`models.srnet.PLAIN_WINDOW` and
#: `PLAIN_LAYOUT`, `ops.unit_kernel.PLAIN_HEAD`).
PLAIN_ROUTES = (
    ("K6", "stage_ensemble_apply_t_mxu_arch", "stage_ensemble_apply_t",
     False, "feature", "mxu"),
    ("K8", "stage_ensemble_apply_mxu_arch", "stage_ensemble_apply",
     True, "site", "mxu"),
    ("K8 vpu", "stage_ensemble_apply_mxu_arch", "stage_ensemble_apply",
     True, "site", "vpu"),
)


@contextlib.contextmanager
def _plain_flags(sn, uk, window, layout, head):
    """The plain routes' flags (all read at each forward), restored on
    exit."""
    old = sn.PLAIN_WINDOW, sn.PLAIN_LAYOUT, uk.PLAIN_HEAD
    sn.PLAIN_WINDOW, sn.PLAIN_LAYOUT, uk.PLAIN_HEAD = window, layout, head
    try:
        yield
    finally:
        sn.PLAIN_WINDOW, sn.PLAIN_LAYOUT, uk.PLAIN_HEAD = old


def _plain_ragged(torch, uk, stacks, frac=ACC_FRAC, tag=""):
    """Each plain entry (K3, K6, K8 with the float32 and with the bf16
    head) on both stages' `_ftr2` stacks at ragged site counts, which the
    batch never reaches.  At n = 1,000,003: against its plain version (the
    per-call gates, K3 also with its stage's mix), and K6's and K8
    "mxu"'s raw accumulators against K3's (no entry may differ: their tap
    matrices are gathered from K3's random plane, 0 outside it).  At n =
    1, 63, 65 and one block's sites -1 and +1: equal, no entry differing,
    to the same sites of a launch whose ragged edge lies elsewhere (K3:
    its plane zero-extended past the last tap; K6, K8: the first n sites
    of the n = 1,000,003 launch), with the reading against the plain
    version printed, not gated (ROADMAP Queue C).  `frac`: the raw
    accumulators' share gate at n = 1,000,003; `tag` heads each line."""
    g = torch.Generator(device="cuda").manual_seed(8)
    M, T, N = len(MODES), PLAIN_BLOCK_SITES, 1_000_003
    P, _ = uk.window_offsets(MODES)
    Wp = W + 2 * P
    plane = torch.rand(N, generator=g, device="cuda").to(torch.bfloat16)
    offs = torch.tensor([o for m in uk.plane_tap_offsets(MODES, Wp)
                         for r in m for o in r], device="cuda")
    q = torch.arange(N, device="cuda")[:, None] + offs
    taps = torch.where((q >= 0) & (q < N), plane[q.clamp(0, N - 1)],
                       torch.zeros((), dtype=plane.dtype, device="cuda"))
    tt = taps.T.contiguous()
    del q
    old_head = uk.PLAIN_HEAD
    sizes = (1, 63, 65, T - 1, T + 1)
    try:
        for s, (st, v, mix) in enumerate(zip(stacks, (1, 16),
                                             ("inner", "final"))):
            kw = dict(modes=MODES, width=Wp)
            for kind in (None, mix):
                got = uk.stage_ensemble_apply_w(st, plane, v=v, mix=kind, **kw)
                want = uk.stage_ensemble_apply_w_plain(st, plane, mix=kind,
                                                       **kw)
                torch.cuda.synchronize()
                _gate(f"{tag}ragged K3 n={N} s{s + 1} "
                      f"{'raw acc' if kind is None else kind} vs plain",
                      _differ(torch, got, want, kind),
                      RAW_ABS if kind is None else MIX_ABS,
                      max_frac=frac if kind is None else ACC_FRAC)
                if kind is None:
                    k3 = got
            k6 = uk.stage_ensemble_apply_t(st, tt, n_modes=M, v=v)
            want = uk.stage_ensemble_apply_t_plain(st, tt, n_modes=M)
            torch.cuda.synchronize()
            _gate(f"{tag}ragged K6 n={N} s{s + 1} raw acc vs plain",
                  _differ(torch, k6, want), RAW_ABS, max_frac=frac)
            _same(f"{tag}K6 n={N} s{s + 1} raw acc vs K3", k6, k3)
            k8 = {}
            for head in uk.HEADS:
                uk.PLAIN_HEAD = head
                k8[head] = uk.stage_ensemble_apply(st, taps, n_modes=M, v=v)
                want = uk.stage_ensemble_apply_plain(st, taps, n_modes=M)
                torch.cuda.synchronize()
                _gate(f"{tag}ragged K8 {head} n={N} s{s + 1} raw acc vs "
                      "plain", _differ(torch, k8[head], want), RAW_ABS,
                      max_frac=frac)
            _same(f"{tag}K8 mxu n={N} s{s + 1} raw acc vs K3", k8["mxu"].T,
                  k3)
            for n in sizes:
                what = f"{tag}n={n} s{s + 1}"
                tn, ttn, pn = (taps[:n].contiguous(), tt[:, :n].contiguous(),
                               plane[:n].contiguous())
                ext = torch.cat([pn, torch.zeros(
                    (P + 1) * (Wp + 1) + 64, dtype=plane.dtype,
                    device=plane.device)])
                got = uk.stage_ensemble_apply_w(st, pn, v=v, **kw)
                _same(f"K3 {what} vs its plane zero-extended", got,
                      uk.stage_ensemble_apply_w(st, ext, v=v, **kw)[:, :n])
                _reading(torch, f"ragged K3 {what}", got,
                         uk.stage_ensemble_apply_w_plain(st, pn, **kw),
                         site_dim=1)
                got = uk.stage_ensemble_apply_t(st, ttn, n_modes=M, v=v)
                _same(f"K6 {what} vs the n={N} launch", got, k6[:, :n])
                _reading(torch, f"ragged K6 {what}", got,
                         uk.stage_ensemble_apply_t_plain(st, ttn, n_modes=M),
                         site_dim=1)
                for head in uk.HEADS:
                    uk.PLAIN_HEAD = head
                    got = uk.stage_ensemble_apply(st, tn, n_modes=M, v=v)
                    _same(f"K8 {head} {what} vs the n={N} launch", got,
                          k8[head][:n])
                    _reading(torch, f"ragged K8 {head} {what}", got,
                             uk.stage_ensemble_apply_plain(st, tn,
                                                           n_modes=M))
    finally:
        uk.PLAIN_HEAD = old_head


def _plain_depth3(torch, uk, imgs):
    """K3 on the depth-3 `_ftr2` weights, for the depth-3 shared-memory
    layout: both stage calls of `upscale_batch` on the batch against their
    plain version, with each call's time, and the 135 x 240 crop on the
    card against the port's CPU path.  Each stage's mixed output is held
    at the per-call gates, its raw accumulator at ACC_FRAC_D3 and
    RAW_ABS, the crop at U8_EQUAL_D3 and the other end-to-end gates."""
    from mulut_tpu_torch.models.torch_import import load_params_npz
    from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

    cfg = dict(stages=STAGES, modes=MODES, scale=SCALE)
    params = load_params_npz(NET_WEIGHTS_D3)
    ev = NetEvaluator(params, fast=True, **cfg)
    (calls,) = _record_calls(uk, ("stage_ensemble_apply_w",),
                             lambda: ev.upscale_batch(imgs))
    if len(calls) != STAGES:
        raise RuntimeError(f"depth 3: recorded {len(calls)} K3 calls")
    for s, ((st, plane), kw) in enumerate(calls):
        pkw = {k: v for k, v in kw.items() if k not in ("v", "mix")}
        what = f"K3 depth {st['hwt'].shape[0]} s{s + 1}"
        got = uk.stage_ensemble_apply_w(st, plane, **dict(kw, mix=None))
        want = uk.stage_ensemble_apply_w_plain(st, plane, **pkw)
        torch.cuda.synchronize()
        _gate(f"{what} raw acc vs plain", _differ(torch, got, want),
              RAW_ABS, max_frac=ACC_FRAC_D3)
        got = uk.stage_ensemble_apply_w(st, plane, **kw)
        want = uk.stage_ensemble_apply_w_plain(st, plane, mix=kw["mix"],
                                               **pkw)
        torch.cuda.synchronize()
        _gate(f"{what} {kw['mix']} {tuple(got.shape)} vs plain",
              _differ(torch, got, want, kw["mix"]), MIX_ABS)
        ms = _cuda_ms(torch, lambda: uk.stage_ensemble_apply_w(
            st, plane, **kw), 10)
        print(f"{what} {kw['mix']}: ms={ms:.4f}")
    crop = np.ascontiguousarray(imgs[0, :CROP_H, :CROP_W])
    _u8_gate(f"K3 depth 3 {CROP_H}x{CROP_W} crop, card vs CPU path",
             ev.upscale(crop),
             NetEvaluator(params, fast=True, device="cpu", **cfg).upscale(
                 crop), equal=U8_EQUAL_D3)


def _plain_route(torch, tk, imgs, params, route, ref, dev3_ms, chain, *,
                 frac=ACC_FRAC, crops=True, plain_reps=2, tag=""):
    """One route of PLAIN_ROUTES on `params` (phases 12 and 14), under its
    flags: `NetEvaluator(fast=True)`; every kernel call of `upscale_batch`
    and `upscale_yuv_batch` against its plain version (raw accumulator at
    share gate `frac`, and its own epilogue), and for the float32 head its
    raw accumulator against K3's on the same stage input, over the image
    sites (no entry may differ: one pass body); both entry points with every
    launch counter set to 0 just before and read just after (2 launches of
    the route's kernel each, none of another), for the float32 head their
    bytes equal to `ref` (the K3 route's); with `crops` the 135 x 240 crop
    card vs CPU path; timings per call site (ms, bound, plain version over
    `plain_reps`, cuBLAS chain yardstick, cached in `chain`) with the
    launch geometry, the route's `srnets_predict_fast` device ms beside
    the K3 route's `dev3_ms`, `upscale_batch` host ms.  Returns (per-batch
    ms totals of the RGB call sites, max |diff| against plain, the
    launches of `upscale_batch`)."""
    from mulut_tpu_torch.models import srnet as sn
    from mulut_tpu_torch.ops import unit_kernel as uk
    from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

    cfg = dict(stages=STAGES, modes=MODES, scale=SCALE)
    counters = (tk.LAUNCHES, uk.LAUNCHES)
    crop = np.ascontiguousarray(imgs[0, :CROP_H, :CROP_W])
    mpix = BATCH * H * SCALE * W * SCALE / 1e6
    P, _ = uk.window_offsets(MODES)
    sites = ["rgb s1", "rgb s2", "yuv s1", "yuv s2"]
    kn, key, wname, window, layout, head = route
    kn = tag + kn
    wrapper = getattr(uk, wname)
    plain_fn = getattr(uk, wname + "_plain")
    with _plain_flags(sn, uk, window, layout, head):
        ev = NetEvaluator(params, fast=True, **cfg)
        nf = ev.stacked[0]["hwt"].shape[2]

        def both():
            ev.upscale_batch(imgs)
            ev.upscale_yuv_batch(imgs)

        (calls,) = _record_calls(uk, (wname,), both)
        if len(calls) != len(sites):
            raise RuntimeError(f"{kn}: recorded {len(calls)} {wname} "
                               f"calls; expected {len(sites)}")
        err = 0.0
        for site, ((st, src), kw) in zip(sites, calls):
            for kind in (None, kw["mix"]):
                kwm = dict(kw, mix=kind)
                got = wrapper(st, src, **kwm)
                want = plain_fn(st, src, **{
                    k: v_ for k, v_ in kwm.items() if k != "v"})
                torch.cuda.synchronize()
                err = max(err, _gate(
                    f"{kn} {site} {'raw acc' if kind is None else kind} "
                    f"{tuple(got.shape)} vs plain",
                    _differ(torch, got, want, kind),
                    RAW_ABS if kind is None else MIX_ABS,
                    max_frac=frac if kind is None else ACC_FRAC))
                if kind is not None or head != "mxu":
                    continue
                # the raw accumulator against K3's on this stage's
                # input, over the image sites: one pass body, so no
                # entry may differ
                img = (src[0] if wname.endswith("_t") else src[:, 0]).reshape(
                    BATCH, -1, H, W)
                plane, (Hp, Wp, _) = sn._window_plane(img, MODES)
                k3 = uk.stage_ensemble_apply_w(st, plane, modes=MODES,
                                               width=Wp, v=kw["v"])
                k3 = k3.view(16, BATCH, -1, Hp, Wp)[
                    ..., P: Hp - P, P: Wp - P].reshape(16, -1)
                raw = got if wname.endswith("_t") else got.T
                _gate(f"{kn} {site} raw acc vs K3 {tuple(k3.shape)}",
                      (raw - k3).abs(), 0, max_frac=0)
        # the main path through the entry points, counted
        for fn, want in zip((ev.upscale_batch, ev.upscale_yuv_batch), ref):
            _reset(*counters)
            out = fn(imgs)
            launches = dict(uk.LAUNCHES)
            print(f"{kn} route {fn.__name__}: {imgs.shape} -> "
                  f"{out.shape}, launches {launches} + LUT "
                  f"{dict(tk.LAUNCHES)}")
            if launches != _only(uk.LAUNCHES, key, 2) or any(
                    tk.LAUNCHES.values()):
                raise RuntimeError(f"{kn} route {fn.__name__} launches "
                                   f"{launches}; expected 2 {key}")
            if out.shape != (BATCH, H * SCALE, W * SCALE, 3) or \
                    out.dtype != np.uint8:
                raise RuntimeError(f"bad output {out.shape} {out.dtype}")
            if fn == ev.upscale_batch:
                count = launches[key]
            if head == "mxu":
                n_diff = int((out != want).sum())
                print(f"{kn} route {fn.__name__} vs the K3 route: "
                      f"{n_diff} of {out.size} bytes differ")
                if n_diff:
                    raise RuntimeError(f"{kn} route bytes differ from K3's")
        if crops:
            t0 = time.perf_counter()
            ev_cpu = NetEvaluator(params, fast=True, device="cpu", **cfg)
            _u8_gate(f"{kn} route {CROP_H}x{CROP_W} crop, card vs CPU path",
                     ev.upscale(crop), ev_cpu.upscale(crop))
            _u8_gate(f"{kn} route {CROP_H}x{CROP_W} crop YUV, card vs CPU",
                     ev.upscale_yuv(crop), ev_cpu.upscale_yuv(crop))
            print(f"{kn} route CPU path: {time.perf_counter() - t0:.1f} s")
            del ev_cpu
        # timings
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            ev.upscale_batch(imgs)
        batch_ms = (time.perf_counter() - t0) * 1e3 / reps
        x = torch.from_numpy(imgs).cuda().permute(0, 3, 1, 2).float() / 255
        dev_ms = _cuda_ms(torch, lambda: sn.srnets_predict_fast(
            ev.stacked, x, **cfg), reps)
        print(f"{kn} route upscale_batch (host clock, H2D + D2H "
              f"included): {batch_ms:.3f} ms/batch = "
              f"{mpix / batch_ms * 1e3:.2f} MPix/s")
        print(f"{kn} route srnets_predict_fast on the card (CUDA "
              f"events): {dev_ms:.3f} ms/batch = "
              f"{mpix / dev_ms * 1e3:.2f} MPix/s (K3 route "
              f"{dev3_ms:.3f})")
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
        for site, ((st, src), kw) in zip(sites, calls):
            n = src.shape[1] if wname.endswith("_t") else src.shape[0]
            D, M, nf, _ = st["hwt"].shape
            flops, nbytes = _plain_work(st, n, src.numel() * 2, kw["v"],
                                        kw["mix"])
            if (n, kw["v"], nf) not in chain:
                chain[n, kw["v"], nf] = _chain_ms(torch, n, M, nf, kw["v"],
                                                  False, D)
            pkw = {k: v_ for k, v_ in kw.items() if k != "v"}
            t = {
                "ms": _cuda_ms(torch, lambda: wrapper(st, src, **kw), 10),
                "plain_ms": _cuda_ms(torch, lambda: plain_fn(
                    st, src, **pkw), plain_reps),
                "bound_ms": max(flops / BF16_FLOPS_PER_MS,
                                nbytes / HBM_BYTES_PER_MS),
                "cublas_chain_ms": chain[n, kw["v"], nf],
            }
            print(f"{kn} {site} {kw['mix']}: image sites={n} "
                  f"flops={flops:.4e} bytes={nbytes} "
                  + " ".join(f"{k}={v_:.4f}" for k, v_ in t.items()))
            print(f"{kn} {site} geometry: " + _plain_geometry(
                n, modes=M, depth=D, head=head, nf=nf))
            if site.startswith("rgb"):
                for k in tot:
                    tot[k] += t[k]
        print(f"{kn} per batch (rgb s1 + s2): "
              + " ".join(f"{k}={v_:.4f}" for k, v_ in tot.items()))
        del ev, calls, x
        torch.cuda.empty_cache()
    return tot, err, count


def _plain_routes(torch, tk, imgs):
    """Phase 12; returns the K6 and K8 entries of the kernels line."""
    from mulut_tpu_torch.models import srnet as sn
    from mulut_tpu_torch.models.torch_import import load_params_npz
    from mulut_tpu_torch.ops import unit_kernel as uk
    from mulut_tpu_torch.ops.taps import rotated_taps
    from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

    cfg = dict(stages=STAGES, modes=MODES, scale=SCALE)
    # a stage's input is its tap source's first tap (mode 0, rotation 0)
    if rotated_taps(MODES[0], 0)[0] != (0, 0):
        raise RuntimeError("tap 0 of the first mode is not the site itself")
    params = load_params_npz(NET_WEIGHTS)
    x = torch.from_numpy(imgs).cuda().permute(0, 3, 1, 2).float() / 255
    chain = {}

    # the K3 route (the default) as every route's reference
    ev3 = NetEvaluator(params, fast=True, **cfg)
    _plain_ragged(torch, uk, ev3.stacked)
    _plain_depth3(torch, uk, imgs)
    ref = ev3.upscale_batch(imgs), ev3.upscale_yuv_batch(imgs)
    dev3_ms = _cuda_ms(torch, lambda: sn.srnets_predict_fast(
        ev3.stacked, x, **cfg), 5)
    print(f"plain K3 route srnets_predict_fast on the card (CUDA events): "
          f"{dev3_ms:.3f} ms/batch")
    del ev3, x
    torch.cuda.empty_cache()
    res = {r[0]: _plain_route(torch, tk, imgs, params, r, ref, dev3_ms, chain)
           for r in PLAIN_ROUTES}
    return [_plain_entry(PLAIN_ROUTES[0][1], SOURCE_K6, REPLACES_K6,
                         res["K6"]),
            _plain_entry(PLAIN_ROUTES[1][1], SOURCE_K8, REPLACES_K8,
                         res["K8"], res["K8 vpu"][1])]


def _plain_entry(name, src, rep, res, err=0.0):
    """A plain route's entry of the kernels line from `_plain_route`'s
    result (`err`: another route's max |diff| of the same kernel)."""
    tot, e, count = res
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": count, "max_abs_err": max(e, err), "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "operations", "library_ms": None}


def _k3_acc64(torch, uk, st, plane, *, modes, width, chunk=1 << 18):
    """K3's raw accumulator (16, n) with every sum in float64 and the bf16
    roundings of the activations and the float32 tanh kept (a reading's
    reference: the exact sums the kernel and its plain version round)."""
    _, offs = uk.window_offsets(modes)
    shifts = [dy * width + dx for dy, dx in offs]
    S = max(abs(o) for o in shifts)
    flat = torch.nn.functional.pad(plane.double(), (S, S))
    cols = torch.as_tensor([j for m in uk.window_tap_rows(modes) for r in m
                            for j in r], device=plane.device)
    f = {k: v.double() for k, v in st.items()}
    n = plane.shape[0]
    out = torch.empty((16, n), device=plane.device)
    for c0 in range(0, n, chunk):
        sites = torch.arange(c0, min(n, c0 + chunk), device=plane.device)
        taps = torch.stack([flat[S + o + sites] for o in shifts], dim=1)
        taps = taps[:, cols]
        acc = torch.zeros((sites.shape[0], 16), device=plane.device)
        for mi in range(len(modes)):
            for r in range(4):
                t = taps[:, (mi * 4 + r) * 4: (mi * 4 + r) * 4 + 4]
                x = torch.relu(t @ f["w1t"][mi].T + f["b1"][mi])
                for d in range(f["hwt"].shape[0]):
                    x = torch.relu(x.to(torch.bfloat16).double()
                                   @ f["hwt"][d, mi].T + f["hb"][d, mi])
                sl = slice(16 * r, 16 * r + 16)
                o = (x.to(torch.bfloat16).double() @ f["w6t"][mi, sl].T
                     + f["b6"][mi, sl])
                acc += torch.round(torch.tanh(o.float()) * 127.0)
        out[:, c0: c0 + sites.shape[0]] = acc.T
    return out


def _exact_sum_readings(torch, uk, imgs):
    """Readings, not gates: for the `_ftr2` weights (nf=128) and the nf=256
    ones, stage 2's raw accumulator of `upscale_batch`'s K3 call from the
    kernel and from its plain version (float32 sums) against `_k3_acc64`:
    how often each departs from exact sums, and the two from each other."""
    from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

    cfg = dict(stages=STAGES, modes=MODES, scale=SCALE)
    for weights in (NET_WEIGHTS, NET_WEIGHTS_NF256):
        ev = NetEvaluator.from_checkpoint(weights, fast=True, **cfg)
        (calls,) = _record_calls(uk, ("stage_ensemble_apply_w",),
                                 lambda: ev.upscale_batch(imgs))
        (st, plane), kw = calls[1]
        wk = dict(modes=kw["modes"], width=kw["width"])
        k = uk.stage_ensemble_apply_w(st, plane, **dict(kw, mix=None))
        p32 = uk.stage_ensemble_apply_w_plain(st, plane, **wk)
        p64 = _k3_acc64(torch, uk, st, plane, **wk)

        def share(a, b):
            return (a != b).float().mean().item()

        print(f"nf={st['hwt'].shape[2]} K3 rgb s2 raw acc, share of entries "
              f"differing: kernel vs float64 sums {share(k, p64):.4e}, "
              f"plain (float32) vs float64 sums {share(p32, p64):.4e}, "
              f"kernel vs plain {share(k, p32):.4e} (readings)")
        del ev, calls, k, p32, p64
        torch.cuda.empty_cache()


def _plain_nf256(torch, tk, imgs):
    """Phase 14: plain net mode on the nf=256 weights (NET_WEIGHTS_NF256);
    returns the nf=256 entries of the kernels line.  Every plain entry at
    ragged n (`_plain_ragged`); how often K3 and its plain version depart
    from exact sums at nf=128 and 256 (`_exact_sum_readings`); then the K3
    route through
    `NetEvaluator.from_checkpoint(..., fast=True)`: every K3 call of
    `upscale_batch` and `upscale_yuv_batch` against its plain version (raw
    accumulator and its own epilogue), both entry points counted (2 K3
    launches each, none of another), the 135 x 240 crop card vs CPU path
    (RGB and YUV), timings per call site with the launch geometry,
    `srnets_predict_fast` device ms, host ms and MPix/s; then K6, K8 "mxu"
    and K8 "vpu" (`_plain_route`; the crop for "vpu", whose bytes are its
    own).  The raw share gate ACC_FRAC_NF256, the others as at nf=128."""
    from mulut_tpu_torch.models import srnet as sn
    from mulut_tpu_torch.models.torch_import import load_params_npz
    from mulut_tpu_torch.ops import unit_kernel as uk
    from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

    cfg = dict(stages=STAGES, modes=MODES, scale=SCALE)
    counters = (tk.LAUNCHES, uk.LAUNCHES)
    crop = np.ascontiguousarray(imgs[0, :CROP_H, :CROP_W])
    mpix = BATCH * H * SCALE * W * SCALE / 1e6
    name, tag = "stage_ensemble_apply_w", "nf=256 "
    t0 = time.perf_counter()
    ev = NetEvaluator.from_checkpoint(NET_WEIGHTS_NF256, fast=True, **cfg)
    torch.cuda.synchronize()
    print(f"nf=256: NetEvaluator.from_checkpoint(fast=True) built in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms; stage stacks "
          + ", ".join(f"{k}{tuple(v.shape)}" for k, v in
                      ev.stacked[1].items()))
    _plain_ragged(torch, uk, ev.stacked, frac=ACC_FRAC_NF256, tag=tag)
    _exact_sum_readings(torch, uk, imgs)

    def both():
        ev.upscale_batch(imgs)
        ev.upscale_yuv_batch(imgs)

    (calls,) = _record_calls(uk, (name,), both)
    sites = ["rgb s1", "rgb s2", "yuv s1", "yuv s2"]
    if len(calls) != len(sites):
        raise RuntimeError(f"nf=256: recorded {len(calls)} K3 calls")
    err = 0.0
    for site, ((st, plane), kw) in zip(sites, calls):
        pkw = {k: v for k, v in kw.items() if k not in ("v", "mix")}
        for kind in (None, kw["mix"]):
            got = uk.stage_ensemble_apply_w(st, plane, **dict(kw, mix=kind))
            want = uk.stage_ensemble_apply_w_plain(st, plane, mix=kind, **pkw)
            torch.cuda.synchronize()
            err = max(err, _gate(
                f"{tag}K3 {site} {'raw acc' if kind is None else kind} "
                f"{tuple(got.shape)} vs plain",
                _differ(torch, got, want, kind),
                RAW_ABS if kind is None else MIX_ABS,
                max_frac=ACC_FRAC_NF256 if kind is None else ACC_FRAC))
            del got, want
    # the main path through the entry points, counted
    ref, count = [], None
    for fn in (ev.upscale_batch, ev.upscale_yuv_batch):
        _reset(*counters)
        out = fn(imgs)
        launches = dict(uk.LAUNCHES)
        print(f"{tag}{fn.__name__}: {imgs.shape} -> {out.shape}, launches "
              f"{launches} + LUT {dict(tk.LAUNCHES)}")
        if launches != _only(uk.LAUNCHES, name, 2) or any(
                tk.LAUNCHES.values()):
            raise RuntimeError(f"{tag}{fn.__name__} launches {launches}; "
                               f"expected 2 {name}")
        if out.shape != (BATCH, H * SCALE, W * SCALE, 3) or \
                out.dtype != np.uint8:
            raise RuntimeError(f"bad output {out.shape} {out.dtype}")
        count = count or launches[name]
        ref.append(out)
    t0 = time.perf_counter()
    params = load_params_npz(NET_WEIGHTS_NF256)
    ev_cpu = NetEvaluator(params, fast=True, device="cpu", **cfg)
    _u8_gate(f"{tag}{CROP_H}x{CROP_W} crop, card vs CPU path",
             ev.upscale(crop), ev_cpu.upscale(crop))
    _u8_gate(f"{tag}{CROP_H}x{CROP_W} crop YUV, card vs CPU path",
             ev.upscale_yuv(crop), ev_cpu.upscale_yuv(crop))
    print(f"{tag}CPU path: {time.perf_counter() - t0:.1f} s")
    del ev_cpu
    # timings
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        ev.upscale_batch(imgs)
    batch_ms = (time.perf_counter() - t0) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        ev.upscale_yuv_batch(imgs)
    yuv_ms = (time.perf_counter() - t0) * 1e3 / reps
    x = torch.from_numpy(imgs).cuda().permute(0, 3, 1, 2).float() / 255
    dev3_ms = _cuda_ms(torch, lambda: sn.srnets_predict_fast(
        ev.stacked, x, **cfg), reps)
    print(f"{tag}upscale_batch (host clock, H2D + D2H included): "
          f"{batch_ms:.3f} ms/batch = {mpix / batch_ms * 1e3:.2f} MPix/s")
    print(f"{tag}upscale_yuv_batch (host clock): {yuv_ms:.3f} ms/batch = "
          f"{mpix / yuv_ms * 1e3:.2f} MPix/s")
    print(f"{tag}srnets_predict_fast on the card (CUDA events): "
          f"{dev3_ms:.3f} ms/batch = {mpix / dev3_ms * 1e3:.2f} MPix/s")
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    chain = {}
    for site, ((st, plane), kw) in zip(sites, calls):
        n, flops, nbytes = _k3_work(st, plane, kw)
        D, M, nf, _ = st["hwt"].shape
        pkw = {k: v for k, v in kw.items() if k != "v"}
        chain[plane.shape[0], kw["v"], nf] = _chain_ms(
            torch, plane.shape[0], M, nf, kw["v"], False, D)
        t = {
            "ms": _cuda_ms(torch, lambda: uk.stage_ensemble_apply_w(
                st, plane, **kw), 10),
            "plain_ms": _cuda_ms(
                torch, lambda: uk.stage_ensemble_apply_w_plain(
                    st, plane, **pkw), 1),
            "bound_ms": max(flops / BF16_FLOPS_PER_MS,
                            nbytes / HBM_BYTES_PER_MS),
            "cublas_chain_ms": chain[plane.shape[0], kw["v"], nf],
        }
        print(f"{tag}K3 {site} {kw['mix']}: image sites={n} kernel "
              f"rows={plane.shape[0]} flops={flops:.4e} bytes={nbytes} "
              + " ".join(f"{k}={v:.4f}" for k, v in t.items()))
        print(f"{tag}K3 {site} geometry: " + _plain_geometry(
            plane.shape[0], modes=M, depth=D, head="mxu", nf=nf))
        if site.startswith("rgb"):
            for k in tot:
                tot[k] += t[k]
    print(f"{tag}K3 per batch (rgb s1 + s2): "
          + " ".join(f"{k}={v:.4f}" for k, v in tot.items()))
    del ev, calls, x
    torch.cuda.empty_cache()
    res = {r[0]: _plain_route(torch, tk, imgs, params, r, ref, dev3_ms,
                              chain, frac=ACC_FRAC_NF256,
                              crops=r[5] == "vpu", plain_reps=1, tag=tag)
           for r in PLAIN_ROUTES}
    k3 = ({k: tot[k] for k in tot}, err, count)
    return [_plain_entry("stage_ensemble_apply_w_nf256", SOURCE_K3,
                         REPLACES_K3, k3),
            _plain_entry(PLAIN_ROUTES[0][1] + "_nf256", SOURCE_K6,
                         REPLACES_K6, res["K6"]),
            _plain_entry(PLAIN_ROUTES[1][1] + "_nf256", SOURCE_K8,
                         REPLACES_K8, res["K8"], res["K8 vpu"][1])]


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mulut_tpu_torch.ops import _build
    from mulut_tpu_torch.ops import simplex as sx
    from mulut_tpu_torch.ops import tail_kernel as tk
    from mulut_tpu_torch.pipelines.evaluate import LutEvaluator

    dev = torch.device("cuda")
    # 1. the card
    smi = _card()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. kernel build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({len(logs)} sources compiled)")
    _ptxas_report(logs)

    # 3. tables on the card
    rng = np.random.default_rng(0)
    luts = _random_luts(rng)
    imgs = rng.integers(0, 256, (BATCH, H, W, 3), dtype=np.int64).astype(
        np.uint8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = LutEvaluator(luts, stages=STAGES, modes=MODES, scale=SCALE,
                      interval=INTERVAL)
    torch.cuda.synchronize()
    tab_bytes = sum(t.numel() * t.element_size() for t in ev.luts.values())
    print(f"tables: {tab_bytes} bytes on the card, built in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    for k, t in ev.luts.items():
        print(f"  {k}: {tuple(t.shape)} {t.dtype}")

    x = torch.from_numpy(np.ascontiguousarray(imgs.transpose(0, 3, 1, 2)))
    x = x.to(dev)

    def cascade():
        return tk.lut_cascade_packed(
            ev.luts, x, stages=STAGES, modes=MODES, scale=SCALE,
            interval=INTERVAL)

    # 4. kernels against their plain versions, on the main path's inputs
    wf_calls, k2_calls = _record_calls(
        tk, ("window_fold_contract", "tail_assemble"), cascade)
    sites = ["s1_s", "s1_d", "s1_y", "s2_s", "s2_d", "s2_y"]
    if len(wf_calls) != len(sites) or len(k2_calls) != 1:
        raise RuntimeError(f"recorded {len(wf_calls)} contraction and "
                           f"{len(k2_calls)} tail calls; expected "
                           f"{len(sites)} and 1")
    wf_err, k1_err, k1_calls = _k1_checks(torch, tk, wf_calls, sites,
                                          "phase 4")
    k2_err = _k2_check(torch, tk, k2_calls[0], "K2")

    # 5. the main path through the entry point, counted
    from mulut_tpu_torch.ops import unit_kernel as uk

    main_launches = {"gather_fold_contract": 0,
                     "window_fold_contract": len(sites), "tail_assemble": 1}
    _reset(tk.LAUNCHES, uk.LAUNCHES)
    with _plain_calls(tk, sx) as plain:
        t0 = time.perf_counter()
        out = ev.upscale_batch(imgs)
        first_s = time.perf_counter() - t0
    launches = dict(tk.LAUNCHES)
    print(f"upscale_batch: {imgs.shape} -> {out.shape} {out.dtype}, "
          f"launches {launches}, plain contraction calls {plain}")
    if (launches != main_launches or any(uk.LAUNCHES.values())
            or any(plain.values())):
        raise RuntimeError(f"main path launches {launches} and plain "
                           f"contraction calls {plain}; expected "
                           f"{main_launches} and none")
    if out.shape != (BATCH, H * SCALE, W * SCALE, 3) or out.dtype != np.uint8:
        raise RuntimeError(f"bad output {out.shape} {out.dtype}")
    t0 = time.perf_counter()
    ev_cpu = LutEvaluator(luts, stages=STAGES, modes=MODES, scale=SCALE,
                          interval=INTERVAL, device="cpu")
    ref = ev_cpu.upscale(imgs[0])
    print(f"CPU path on frame 0: {time.perf_counter() - t0:.1f} s")
    if not np.array_equal(ref, out[0]):
        raise RuntimeError("frame 0 differs between the card and the CPU "
                           f"path ({int((ref != out[0]).sum())} bytes)")
    print("frame 0 byte-equal to the CPU path")
    crops = np.ascontiguousarray(imgs[:2, :CROP_H, :CROP_W])
    for interval in (5, 6):
        luts_i = _random_luts(np.random.default_rng(interval), interval)
        cfg = dict(stages=STAGES, modes=MODES, scale=SCALE, interval=interval)
        _reset(tk.LAUNCHES)
        got_i = LutEvaluator(luts_i, **cfg).upscale_batch(crops)
        launches_i = dict(tk.LAUNCHES)
        want_i = LutEvaluator(luts_i, **cfg, device="cpu").upscale_batch(crops)
        if launches_i != main_launches or not np.array_equal(got_i, want_i):
            raise RuntimeError(
                f"interval {interval}: launches {launches_i}, "
                f"{int((got_i != want_i).sum())} bytes differ from the CPU "
                "path")
        print(f"interval {interval}: upscale_batch {crops.shape} byte-equal "
              f"to the CPU path, launches {launches_i}")

    # 6. timings
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        ev.upscale_batch(imgs)
    batch_ms = (time.perf_counter() - t0) * 1e3 / reps
    dev_ms = _cuda_ms(torch, cascade, reps)
    mpix = BATCH * H * SCALE * W * SCALE / 1e6
    print(f"upscale_batch (host clock, H2D + D2H included): "
          f"{batch_ms:.3f} ms/batch = {mpix / batch_ms * 1e3:.2f} MPix/s "
          f"(first call {first_s * 1e3:.1f} ms)")
    print(f"lut_cascade_packed on the card (CUDA events): {dev_ms:.3f} "
          f"ms/batch = {mpix / dev_ms * 1e3:.2f} MPix/s")

    # wf_site_ms: per call site, for phase 13's tables beside these
    wf, wf_site_ms = _window_timings(torch, tk, wf_calls, sites, "phase 6")
    k1 = _boundary_timings(torch, tk, k1_calls)
    k2 = _k2_timings(torch, tk, k2_calls[0], "K2")
    _profile(torch, cascade, dev_ms)
    del ev, ev_cpu, wf_calls, k1_calls, k2_calls
    torch.cuda.empty_cache()

    net_entries = _net_mode(torch, tk, imgs)
    net_entries.append(_quant_mode(torch, tk, imgs))
    net_entries += _dense_routes(torch, tk, imgs)
    net_entries += _plain_routes(torch, tk, imgs)
    trained = _training_half(torch, tk, imgs, (dev_ms, wf_site_ms))
    net_entries += _plain_nf256(torch, tk, imgs)
    net_entries += _lut_rank(torch, tk, imgs, out)
    _parallel(torch, tk, imgs)
    net_entries += _tasks(torch, tk, imgs, trained)
    net_entries += _cli(torch, tk)

    print(json.dumps({"kernels": [
        {"name": "window_fold_contract", "route": "cuda",
         "source": SOURCE_K1W, "replaces": REPLACES_K1,
         "launches": launches["window_fold_contract"],
         "max_abs_err": wf_err, "ms": wf["ms"], "plain_ms": wf["plain_ms"],
         "bound_ms": wf["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "gather_fold_contract", "route": "cuda",
         "source": SOURCE_K1, "replaces": REPLACES_K1,
         "launches": launches["gather_fold_contract"],
         "max_abs_err": k1_err, "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": "bytes",
         "library_ms": k1["library_ms"]},
        {"name": "tail_assemble", "route": "cuda",
         "source": SOURCE_K2, "replaces": REPLACES_K2,
         "launches": launches["tail_assemble"],
         "max_abs_err": k2_err, "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
    ] + net_entries}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _ab(kind, roots) -> int:
    """One-card A/B of versions of the port, one process per ROOT in the
    order given (give parent, change, change, parent): `_plain_ab_one`
    (kind "plain") or `_w8a8_ab_one` ("w8a8") on each."""
    here = os.path.dirname(os.path.abspath(__file__))
    print(f"card: {_card()}")
    for root in roots:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--ab-one", kind, os.path.abspath(root)],
                       cwd=here, check=True, timeout=900)
    print(f"card: {_card()}")
    return 0


def _ab_setup(root, sources):
    """The package of one A/B version imported from root, its kernels
    built (ptxas's report of `sources`), the main run's batch; returns
    (torch, unit_kernel module, NetEvaluator, batch, tag, reading)."""
    sys.path.insert(0, root)
    import torch

    from mulut_tpu_torch.models import srnet as sn
    from mulut_tpu_torch.ops import _build
    from mulut_tpu_torch.ops import unit_kernel as uk
    from mulut_tpu_torch.pipelines.evaluate import NetEvaluator

    if not sn.__file__.startswith(root):
        raise RuntimeError(f"imported {sn.__file__}, not from {root}")
    tag = os.path.basename(root.rstrip("/"))
    logs = _build.build_all()
    _ptxas_report({k: v for k, v in logs.items() if sources(k)})
    rng = np.random.default_rng(0)
    _random_luts(rng)   # the main run's draws, so imgs are its batch
    imgs = rng.integers(0, 256, (BATCH, H, W, 3), dtype=np.int64).astype(
        np.uint8)

    def reading(what, d):
        frac, err = (d > 0).float().mean().item(), d.max().item()
        hist = {k: int((d == k).sum()) for k in range(1, int(err) + 1)}
        print(f"[{tag}] {what}: {frac:.3e} differ, max {err:g}, {hist}")

    return torch, uk, NetEvaluator, imgs, tag, reading


def _w8a8_ab_one(root) -> int:
    """One version of the K11 A/B: ptxas's report of plain_w8a8; for
    "int" and "f32" on the `_ftr2` weights (nf=128) and the nf=256 ones,
    the batch's two K11 stage calls of `upscale_batch` against their plain
    version (share of differing entries, max |diff|) and each call's ms;
    a version whose K11 refuses nf=256 says so.  Readings, not gates."""
    torch, uk, NetEvaluator, imgs, tag, reading = _ab_setup(
        root, lambda k: k == "plain_w8a8")
    cfg = dict(stages=STAGES, modes=MODES, scale=SCALE)
    for weights in (NET_WEIGHTS, NET_WEIGHTS_NF256):
        for quant in (True, "f32"):
            ev = NetEvaluator.from_checkpoint(weights, quant=quant, **cfg)
            nf = ev.stacked[0]["w1t"].shape[1]
            what = f"nf={nf} {quant!r}"
            try:
                (calls,) = _record_calls(uk, ("stage_ensemble_apply_q",),
                                         lambda: ev.upscale_batch(imgs))
            except NotImplementedError as e:
                print(f"[{tag}] K11 {what}: not run ({e})")
                continue
            tot = 0.0
            for s, ((st, taps), kw) in enumerate(calls):
                got = uk.stage_ensemble_apply_q(st, taps, **kw)
                want = uk.stage_ensemble_apply_q_plain(
                    st, taps, n_modes=kw["n_modes"])
                torch.cuda.synchronize()
                reading(f"K11 {what} s{s + 1} raw acc vs plain",
                        _differ(torch, got, want))
                del got, want
                ms = _cuda_ms(torch, lambda: uk.stage_ensemble_apply_q(
                    st, taps, **kw), 20)
                tot += ms
                print(f"[{tag}] K11 {what} s{s + 1} ms={ms:.4f}")
            print(f"[{tag}] K11 {what} per batch ms={tot:.4f}")
            del ev, calls
            torch.cuda.empty_cache()
    return 0


def _plain_ab_one(root) -> int:
    """One version of the plain-body A/B.  Each line tagged with its
    directory's name: ptxas's report of the plain sources; on the batch's
    two K3 stage calls of `upscale_batch`, at depth 2 and 3 (the `_ftr2`
    weights), the raw and the mixed output against the plain version
    (share of differing entries, max |diff|, count by |diff|) and each
    call's ms; per stage stack, K8 with either head and K6 on random taps
    of a stage call's size, ms; the dense K4 route's two stage calls (the
    dense weights of phase 11), ms; the depth-3 135 x 240 crop card vs
    CPU; then the same K3, K8 and K6 readings on the nf=256 weights (a
    version that refuses nf=256 says so).  Readings, not gates."""
    torch, uk, NetEvaluator, imgs, tag, reading = _ab_setup(
        root, lambda k: k.startswith("plain_") and k != "plain_w8a8")
    from mulut_tpu_torch.models import srnet as sn
    from mulut_tpu_torch.models.torch_import import load_params_npz

    cfg = dict(stages=STAGES, modes=MODES, scale=SCALE)

    def routes(wname):
        params = load_params_npz(wname)
        ev = NetEvaluator(params, fast=True, **cfg)
        (calls,) = _record_calls(uk, ("stage_ensemble_apply_w",),
                                 lambda: ev.upscale_batch(imgs))
        D, _, nf, _ = calls[0][0][0]["hwt"].shape
        lab = f"d{D}" if nf == 128 else f"nf{nf} d{D}"
        for s, ((st, plane), kw) in enumerate(calls):
            pkw = {k: v for k, v in kw.items() if k not in ("v", "mix")}
            for kind in (None, kw["mix"]):
                got = uk.stage_ensemble_apply_w(st, plane,
                                                **dict(kw, mix=kind))
                want = uk.stage_ensemble_apply_w_plain(st, plane, mix=kind,
                                                       **pkw)
                torch.cuda.synchronize()
                reading(f"{lab} K3 s{s + 1} {kind}",
                        _differ(torch, got, want, kind))
            ms = _cuda_ms(torch, lambda: uk.stage_ensemble_apply_w(
                st, plane, **kw), 20)
            print(f"[{tag}] {lab} K3 s{s + 1} ms={ms:.4f}")
        g = torch.Generator(device="cuda").manual_seed(1)
        taps = torch.rand((H * W * BATCH * 3, 48), generator=g,
                          device="cuda").to(torch.bfloat16)
        tt = taps.T.contiguous()
        old = uk.PLAIN_HEAD
        try:
            for s, (v, mix) in enumerate(((1, "inner"), (16, "final"))):
                st = ev.stacked[s]
                for head in uk.HEADS:
                    uk.PLAIN_HEAD = head
                    ms = _cuda_ms(torch, lambda: uk.stage_ensemble_apply(
                        st, taps, n_modes=3, v=v, mix=mix), 20)
                    print(f"[{tag}] {lab} K8 {head} s{s + 1} ms={ms:.4f}")
                uk.PLAIN_HEAD = "mxu"
                ms = _cuda_ms(torch, lambda: uk.stage_ensemble_apply_t(
                    st, tt, n_modes=3, v=v, mix=mix), 20)
                print(f"[{tag}] {lab} K6 s{s + 1} ms={ms:.4f}")
        finally:
            uk.PLAIN_HEAD = old
        del taps, tt
        torch.cuda.empty_cache()
        return params, ev

    routes(NET_WEIGHTS)
    params, ev = routes(NET_WEIGHTS_D3)
    crop = np.ascontiguousarray(imgs[0, :CROP_H, :CROP_W])
    card = ev.upscale(crop)
    ref = NetEvaluator(params, fast=True, device="cpu", **cfg).upscale(crop)
    d = np.abs(card.astype(np.int64) - ref)
    hist = {k: int((d == k).sum()) for k in range(1, int(d.max()) + 1)}
    print(f"[{tag}] d3 crop: {float((d == 0).mean()):.6f} equal, "
          f"{float((d <= 2).mean()):.6f} within 2, max {int(d.max())}, "
          f"{hist}")
    dense = sn.init_srnets(np.random.default_rng(0), nf=64, arch="dense",
                           **cfg)
    ev4 = NetEvaluator(dense, fast=True, **cfg)
    (calls,) = _record_calls(uk, ("stage_ensemble_apply",),
                             lambda: ev4.upscale_batch(imgs))
    for s, ((st, taps), kw) in enumerate(calls):
        ms = _cuda_ms(torch, lambda: uk.stage_ensemble_apply(st, taps, **kw),
                      20)
        print(f"[{tag}] dense K4 s{s + 1} ms={ms:.4f}")
    del ev4, calls
    torch.cuda.empty_cache()
    try:
        routes(NET_WEIGHTS_NF256)
    except NotImplementedError as e:
        print(f"[{tag}] nf=256: not run ({e})")
    return 0


def _sass(names) -> int:
    """Per kernel instance of the given sources (default plain_w8a8):
    its SASS instruction count by opcode, from `cuobjdump -sass` of the
    built library beside nvcc (static counts: a loop body counts once)."""
    import collections
    import re
    import shutil

    from mulut_tpu_torch.ops import _build

    print(f"card: {_card()}")
    _build.build_all()
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for name in names or ["plain_w8a8"]:
        sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        for part in sass.split("Function : ")[1:]:
            entry = part.split("\n", 1)[0].strip()
            if shutil.which("c++filt"):
                entry = subprocess.run(["c++filt", entry], capture_output=True,
                                       text=True, timeout=60).stdout.strip()
            ops = collections.Counter(
                m.group(1) for m in re.finditer(
                    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                    part))
            print(f"sass {name}: {entry}: {sum(ops.values())} instructions; "
                  + ", ".join(f"{op} {n}" for op, n in ops.most_common()))
    return 0


def _synthetic_div2k(root: str, *, images: int, hr: int, seed: int = 0):
    """A DIV2K tree that `data.DIV2K` reads, written without PIL: HR
    images from the port's `_synth_image`, x4 LR images by a 4 x 4 box
    average, the two pickled caches `DIV2K` loads and the HR names it
    lists (empty files)."""
    from mulut_tpu_torch.data.synthetic import _synth_image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "HR"))
    hr_ims, lr_ims = {}, {}
    for i in range(1, images + 1):
        name = f"{i:04d}"
        im = _synth_image(rng, hr)
        lr = im.reshape(hr // SCALE, SCALE, hr // SCALE, SCALE, 3).mean((1, 3))
        hr_ims[name], lr_ims[name] = im, np.round(lr).astype(np.uint8)
        open(os.path.join(root, "HR", f"{name}.png"), "wb").close()
    np.save(os.path.join(root, "cache_hr.npy"), hr_ims, allow_pickle=True)
    np.save(os.path.join(root, f"cache_lr_x{SCALE}.npy"), lr_ims,
            allow_pickle=True)


def _train_opt(train_dir, val_dir, exp, **kw):
    """`utils/options.py` TrainOptions' attributes for `train` and
    `finetune`: its defaults with this phase's sizes."""
    import types

    base = dict(nf=TRAIN["nf"], arch="dense", unitDepth=0, modes=MODES,
                stages=STAGES, scale=SCALE, interval=INTERVAL,
                batchSize=TRAIN["batch"], cropSize=TRAIN["crop"],
                trainDir=train_dir, valDir=val_dir, startIter=0,
                totalIter=TRAIN["steps"], lr0=1e-3, lr1=1e-4, weightDecay=0,
                displayStep=5, valStep=100_000, saveStep=100_000,
                workerNum=4, expDir=exp, valoutDir=os.path.join(exp, "val"),
                debug=False, trainPrecision="f32", gpuNum=1)
    base.update(kw)
    os.makedirs(exp, exist_ok=True)
    return types.SimpleNamespace(**base)


def _timed_steps(torch, module, name, dev):
    """Wrap `module.<name>` (a step factory) so that each step it makes
    is timed with CUDA events on `dev` (host clock on the CPU, where
    this phase is rehearsed) and its loss kept; returns the record and a
    function that restores the factory."""
    rec = {"ms": [], "loss": []}
    make = getattr(module, name)

    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def timed(*args):
            if dev.type == "cuda":
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
                out = step(*args)
                ev[1].record()
                rec["ms"].append(ev)
            else:
                t0 = time.perf_counter()
                out = step(*args)
                rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["loss"].append(out)
            return out

        return timed

    setattr(module, name, wrapped)
    return rec, lambda: setattr(module, name, make)


def _step_readings(torch, rec, what, flops=None):
    """Per-step ms and losses of a `_timed_steps` record: prints them (of
    a run of more than 24 steps the first and last three, and the ms'
    min and max), fails on a loss that is not finite; with `flops`, the
    float32 operations of one step, prints its bound over the SIMT peak.
    Returns the median ms of steps 6 on."""
    if rec["ms"] and not isinstance(rec["ms"][0], float):
        torch.cuda.synchronize()
        rec["ms"] = [a.elapsed_time(b) for a, b in rec["ms"]]
    losses, ms = [float(x) for x in rec["loss"]], rec["ms"]
    long = len(losses) > 24

    def listed(xs, digits):
        if long:
            xs = xs[:3] + ["..."] + xs[-3:]
        return " ".join(x if x == "..." else f"{x:.{digits}f}" for x in xs)

    print(f"{what}: {len(losses)} steps, loss per step " + listed(losses, 6))
    if not losses or not all(np.isfinite(losses)):
        raise RuntimeError(f"{what}: losses {listed(losses, 6)}")
    med = float(np.median(ms[5:] or ms))
    print(f"{what}: ms per step (CUDA events) " + listed(ms, 3)
          + f"; median of steps 6-{len(losses)}: {med:.3f}"
          + (f", min {min(ms):.3f}, max {max(ms):.3f}" if long else "")
          + ("" if flops is None else
             f"; bound {flops / FP32_FLOPS_PER_MS:.3f} ms ({flops / 1e9:.3f}"
             " GFLOP float32 per step over 67 TFLOP/s)"))
    return med


def _grad_gate(what, got, want, loss_rel, grad_rel,
               names=("card", "CPU")):
    """One step's (loss, {name: grad}) on the card against the CPU path
    (or `names` (got, want)); a gate left None is a reading only.  A loss
    or gradient ratio that is not finite (a NaN or inf on either side)
    fails, gate or reading."""
    (lg, gg), (lw, gw) = got, want
    rel = abs(lg - lw) / abs(lw)
    worst, worst_key, finite = 0.0, None, math.isfinite(rel)
    for k, w in gw.items():
        r = float((gg[k].cpu() - w).abs().max() / w.abs().max())
        if not math.isfinite(r):
            finite, worst, worst_key = False, r, k
            break
        if r > worst:
            worst, worst_key = r, k
    print(f"{what}: loss {names[0]} {lg:.9g} {names[1]} {lw:.9g} (rel "
          f"{rel:.3e}{_gate_note(loss_rel)}); worst gradient {worst_key} "
          f"rel to its max {worst:.3e}{_gate_note(grad_rel)} over "
          f"{len(gw)} tensors")
    if (not finite or (loss_rel is not None and not rel <= loss_rel)
            or (grad_rel is not None and not worst <= grad_rel)):
        raise RuntimeError(f"{what}: {names[0]} departs from {names[1]}")


def _gate_note(gate):
    return ", a reading" if gate is None else f", gate {gate}"


def _loss_and_grads(torch, loss_fn, leaves):
    """Run `loss_fn()` and its backward; (loss, {name: grad on the CPU})."""
    loss = loss_fn()
    loss.backward()
    return loss.item(), {k: t.grad.detach().cpu() for k, t in leaves}


def _cascade_sites(torch, tk, ev, x, what, phase6):
    """The LUT cascade on `ev`'s tables and the (B, C, H, W) card batch
    `x`: device ms and each contraction call site's ms, beside phase 6's
    random-table readings when given."""
    def cascade():
        return tk.lut_cascade_packed(ev.luts, x, stages=STAGES, modes=MODES,
                                     scale=SCALE, interval=INTERVAL)

    (calls,) = _record_calls(tk, ("window_fold_contract",), cascade)
    sites = ["s1_s", "s1_d", "s1_y", "s2_s", "s2_d", "s2_y"]
    ms = _cuda_ms(torch, cascade, 10)
    ref_ms, ref_sites = phase6 if phase6 else (None, {})

    def beside(site=None):
        ref = ref_ms if site is None else ref_sites.get(site)
        return (f" (phase 6, random tables: {ref:.4f})" if ref is not None
                else " (phase 6 not run)")

    print(f"{what}: lut_cascade_packed {ms:.4f} ms per batch" + beside())
    total = 0.0
    for site, ((tab, xp), kw) in zip(sites, calls, strict=True):
        t = _cuda_ms(torch, lambda: tk.window_fold_contract(tab, xp, **kw),
                     20)
        total += t
        print(f"{what}: window_fold_contract {site} {t:.4f} ms" + beside(site))
    print(f"{what}: window_fold_contract, the 6 call sites {total:.4f} ms"
          + (f" (phase 6: {sum(ref_sites.values()):.4f})" if ref_sites
             else ""))


def _training_half(torch, tk, imgs, phase6=None, *, dev="cuda", sizes=None):
    """Phase 13: the training half on the card (module docstring); returns
    the trained params (phase 17's teachers).  `dev` and `sizes` (keys of
    TRAIN) exist for a rehearsal on the CPU at a small size; the card run
    takes the defaults."""
    import tempfile

    from mulut_tpu_torch.data import DIV2K
    from mulut_tpu_torch.models import lut_model as lm
    from mulut_tpu_torch.models.srnet import init_srnets
    from mulut_tpu_torch.models.torch_import import load_params_npz
    from mulut_tpu_torch.ops import unit_kernel as uk
    from mulut_tpu_torch.ops.resize import full_f32_matmul
    ftm = importlib.import_module("mulut_tpu_torch.pipelines.finetune")
    trm = importlib.import_module("mulut_tpu_torch.pipelines.train")
    from mulut_tpu_torch.pipelines import transfer as tfm
    from mulut_tpu_torch.pipelines.evaluate import LutEvaluator
    from mulut_tpu_torch.utils.lut_io import lut_filename

    dev = torch.device(dev)
    size = dict(TRAIN, **(sizes or {}))
    cfg = dict(modes=MODES, stages=STAGES)
    card = dev.type == "cuda"

    def peak_reset():
        if card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        if not card:
            return "not measured (CPU)"
        torch.cuda.synchronize()
        return f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"

    with tempfile.TemporaryDirectory() as root:
        train_dir = os.path.join(root, "DIV2K")
        val_dir = os.path.join(root, "no_benchmark")
        os.makedirs(val_dir)
        _synthetic_div2k(train_dir, images=size["images"], hr=size["hr"])
        im, lb = DIV2K(SCALE, train_dir, size["crop"], seed=0).sample_batch(
            size["batch"])
        print(f"training half: synthetic DIV2K {size['images']} x "
              f"{size['hr']}^2 (x{SCALE} LR by box average, pickled caches, "
              f"no PIL); batch {im.shape} -> {lb.shape} uint8")

        # 13a. step 1: one step, card against the CPU path
        params = init_srnets(np.random.default_rng(0), nf=size["nf"],
                             arch="dense", scale=SCALE, **cfg)
        step_io = {}
        for d in (dev, torch.device("cpu")):
            p = trm.trainable(params, d)
            leaves = [((u, n), p[u][n]) for u in sorted(p) for n in
                      sorted(p[u])]
            t0 = time.perf_counter()
            with full_f32_matmul():
                step_io[d.type] = _loss_and_grads(torch, lambda: trm.train_loss(
                    p, torch.from_numpy(im).to(d), torch.from_numpy(lb).to(d),
                    scale=SCALE, **cfg), leaves)
            print(f"train step loss + backward on {d.type}: "
                  f"{time.perf_counter() - t0:.2f} s (first call, host clock)")
            del p, leaves
        _grad_gate("train step, card vs CPU", step_io[dev.type],
                   step_io["cpu"], TRAIN_LOSS_REL, TRAIN_GRAD_REL)
        del step_io

        # 13b. train(opt)
        rec, restore = _timed_steps(torch, trm, "make_train_step", dev)
        opt = _train_opt(train_dir, val_dir, os.path.join(root, "train"),
                         totalIter=size["steps"], nf=size["nf"],
                         batchSize=size["batch"], cropSize=size["crop"])
        peak_reset()
        try:
            trained = trm.train(opt, device=dev)
        finally:
            restore()
        train_ms = _step_readings(torch, rec, "train(opt)")
        # the bound: forward multiply-adds of every unit pass (4 rotations x
        # M modes per LR site and stage), x2 flops, x3 with the backward
        # (input and weight gradients), over the float32 peak outside the
        # tensor cores (TF32 is off)
        macs = sum(t.size for s_ in range(STAGES) for n, t in
                   params[f"s{s_ + 1}_{MODES[0]}"].items() if n[0] == "w")
        flops = 3 * 2 * macs * size["batch"] * size["crop"] ** 2 * 4 * len(
            MODES)
        print(f"train(opt): {train_ms:.3f} ms per step, peak memory "
              f"{peak()}; bound {flops / FP32_FLOPS_PER_MS:.3f} ms "
              f"({flops / 1e12:.4f} TFLOP per step over 67 TFLOP/s float32)")
        batch = (torch.from_numpy(im).to(dev), torch.from_numpy(lb).to(dev))
        if card:        # on a copy of the trained params
            p = trm.trainable(trained, dev)
            step = trm.make_train_step(trm.make_optimizer(
                trm.param_leaves(p), 1e-3, 1e-4, 100), scale=SCALE, **cfg)
            _profile(torch, lambda: step(p, *batch), train_ms, top=12,
                     what="train step")
            del p, step

        # 13c. step 2: transfer, card against the CPU path
        ftr2 = load_params_npz(NET_WEIGHTS)
        tables = {}
        for what, p in (("trained", trained), ("ftr2", ftr2)):
            flips, unit_ms = 0, []
            for key in sorted(p):
                if card:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = tfm.cache_lut(p[key], device=dev)
                unit_ms.append((time.perf_counter() - t0) * 1e3)
                want = tfm.cache_lut(p[key], device="cpu")
                d = np.abs(got.astype(int) - want.astype(int))
                off = np.argwhere(d > 0)
                flips += len(off)
                print(f"transfer {what} {key}: {got.shape} int8, "
                      f"{len(off)} entries off the CPU path"
                      + (f" (first row {off[0][0]} lane {off[0][1]}: card "
                         f"{got[tuple(off[0])]}, CPU {want[tuple(off[0])]})"
                         if len(off) else ""))
                if d.max() > 1 or len(off) > CACHE_FLIP_SHARE * d.size:
                    raise RuntimeError(f"transfer {what} {key}: {len(off)} "
                                       f"entries off, max {d.max()}")
                tables.setdefault(what, {})[key] = got
            print(f"transfer {what}: {flips} tie flips in all; ms per unit "
                  "(host clock, params to the card and the table back) "
                  + " ".join(f"{x:.2f}" for x in unit_ms)
                  + f"; median {float(np.median(unit_ms)):.2f}")

        # 13d. step 3: fine-tune the _ftr2 tables
        ft_exp = os.path.join(root, "finetune")
        os.makedirs(ft_exp)
        for key, arr in tables["ftr2"].items():
            np.save(os.path.join(ft_exp, lut_filename(
                "LUT", SCALE, INTERVAL, int(key[1]), key[3:])), arr)
        ft_io, fwd = {}, {}
        for d in (dev, torch.device("cpu")):
            w = lm.init_lut_weights_from_arrays(tables["ftr2"], upscale=SCALE,
                                                device=d, **cfg)
            x = lm.unit_pixels(torch.from_numpy(im).to(d))
            with torch.no_grad():
                fwd[d.type] = lm.lut_model_forward(
                    w, x, upscale=SCALE, device=d, **cfg).cpu()
            for t in w.values():
                t.requires_grad_(True)
            t0 = time.perf_counter()
            ft_io[d.type] = _loss_and_grads(torch, lambda: ftm.finetune_loss(
                w, torch.from_numpy(im).to(d), torch.from_numpy(lb).to(d),
                upscale=SCALE, interval=INTERVAL, **cfg), sorted(w.items()))
            print(f"fine-tune step loss + backward on {d.type}: "
                  f"{time.perf_counter() - t0:.2f} s (first call, host clock)")
            del w
        n_off = int((fwd[dev.type] != fwd["cpu"]).sum())
        print(f"lut_model_forward {tuple(fwd['cpu'].shape)}: {n_off} values "
              "differ between the card and the CPU path")
        if n_off:
            raise RuntimeError("lut_model_forward: card differs from CPU")
        _grad_gate("fine-tune step, card vs CPU", ft_io[dev.type],
                   ft_io["cpu"], FT_LOSS_REL, FT_GRAD_REL)
        del ft_io, fwd

        rec, restore = _timed_steps(torch, ftm, "make_finetune_step", dev)
        opt = _train_opt(train_dir, val_dir, ft_exp, totalIter=size[
            "ft_steps"], batchSize=size["batch"], cropSize=size["crop"])
        peak_reset()
        try:
            weights = ftm.finetune(opt, device=dev)
        finally:
            restore()
        ft_ms = _step_readings(torch, rec, "finetune(opt)")
        print(f"finetune(opt): {ft_ms:.3f} ms per step, peak memory {peak()}")
        if card:        # on a copy of the fine-tuned tables
            w = {k: t.detach().clone().requires_grad_(True)
                 for k, t in weights.items()}
            step = ftm.make_finetune_step(trm.make_optimizer(
                [w[k] for k in sorted(w)], 1e-3, 1e-4, 100), upscale=SCALE,
                interval=INTERVAL, **cfg)
            _profile(torch, lambda: step(w, *batch), ft_ms, top=12,
                     what="fine-tune step")
            del w, step

        # 13e. deploy the fine-tuned tables
        luts = lm.export_lut_weights(weights)
        ev = LutEvaluator(luts, stages=STAGES, modes=MODES, scale=SCALE,
                          interval=INTERVAL, device=dev)
        _reset(tk.LAUNCHES, uk.LAUNCHES)
        out = ev.upscale_batch(imgs)
        launches = dict(tk.LAUNCHES)
        want_launches = {"gather_fold_contract": 0,
                         "window_fold_contract": 6, "tail_assemble": 1}
        if card and (launches != want_launches or any(uk.LAUNCHES.values())):
            raise RuntimeError(f"deploy launches {launches}, expected "
                               f"{want_launches}")
        ref = LutEvaluator(luts, stages=STAGES, modes=MODES, scale=SCALE,
                           interval=INTERVAL, device="cpu").upscale_batch(imgs)
        if not np.array_equal(out, ref):
            raise RuntimeError(f"deploy: {int((out != ref).sum())} bytes "
                               "differ from the CPU path")
        print(f"deploy: fine-tuned tables, upscale_batch {imgs.shape} -> "
              f"{out.shape} byte-equal to the CPU path, launches {launches}")
        if not card:
            return trained
        x = torch.from_numpy(np.ascontiguousarray(
            imgs.transpose(0, 3, 1, 2))).to(dev)
        _cascade_sites(torch, tk, ev, x, "deploy, bench batch", phase6)
        from mulut_tpu_torch.data.synthetic import _synth_image

        rng = np.random.default_rng(1)
        frames = np.stack([_synth_image(rng, W)[:H] for _ in range(BATCH)])
        x = torch.from_numpy(np.ascontiguousarray(
            frames.transpose(0, 3, 1, 2))).to(dev)
        _cascade_sites(torch, tk, ev, x, "deploy, structured frames", phase6)
    return trained


#: Phase 15 (`_lut_rank`): the LUT configurations of the rank-format tables
#: and the integer cascade.  Per label: (stages, modes, scale, interval
#: (None: INTERVAL), the table flags, the packed cascade); random int8 LUTs
#: from seed 15 (the all-rank x4 run uses phase 3's LUTs).  "x2-s-i3" is
#: the interval-3 configuration of tests/test_interval3.py: L = 33, too
#: many rows for rank tables, so 16-corner folded rows.
LUT_RANK = {
    "x4-sdyeho": (2, "sdyeho", 4, None, "kernel", True),
    "x4-rank": (2, "sdy", 4, None, "rank", True),
    "x2-sdy": (2, "sdy", 2, None, "default", False),
    "x3-sdy": (2, "sdy", 3, None, "default", False),
    "x2-eho": (2, "eho", 2, None, "default", False),
    "x2-s-i3": (1, "s", 2, 3, "default", False),
}


def _lut_rank(torch, tk, imgs, ref16=None, *, dev="cuda"):
    """Phase 15: the rank-format tables and the integer cascade on the card
    (module docstring).  `ref16` is phase 5's `upscale_batch` output on
    phase 3's LUTs, recomputed when not given.  `dev` exists for a
    rehearsal on the CPU at a small size (with `_cuda_ms` and the
    `torch.cuda` calls stubbed); the card run takes the default."""
    from mulut_tpu_torch.ops import ensemble as ens
    from mulut_tpu_torch.ops import simplex as sx
    from mulut_tpu_torch.pipelines.evaluate import LutEvaluator

    dev = torch.device(dev)
    card = dev.type == "cuda"
    x = torch.from_numpy(np.ascontiguousarray(imgs.transpose(0, 3, 1, 2))).to(
        dev)
    crop = np.ascontiguousarray(imgs[:2, :CROP_H, :CROP_W])
    mpix_per = BATCH * H * W / 1e6
    lut3 = _random_luts(np.random.default_rng(0), INTERVAL)  # phase 3
    entries, boundary, boundary_launches, boundary_err = [], [], 0, 0.0
    for label, (stages, modes, scale, interval, flags, packed) in \
            LUT_RANK.items():
        interval = interval or INTERVAL
        rng = np.random.default_rng(15)
        L = 2 ** (8 - interval) + 1
        luts = lut3 if label == "x4-rank" else {
            f"s{s + 1}_{m}": rng.integers(
                -127, 128, (L ** 4, scale ** 2 if s + 1 == stages else 1),
                dtype=np.int64).astype(np.int8)
            for s in range(stages) for m in modes}
        cfg = dict(stages=stages, modes=modes, scale=scale, interval=interval)
        # tables on the card: build time, bytes, peak memory of the build
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        if flags == "rank":
            ev = None
            tabs = ens.prepare_expanded_luts(luts, interval=interval,
                                             shared_quad=True, device=dev)
        else:
            ev = LutEvaluator(luts, **cfg, device=dev)
            tabs = ev.luts
            if ev.kernel != packed:
                raise RuntimeError(f"{label}: packed path {ev.kernel}")
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - mem0
        tab_bytes = sum(t.numel() * t.element_size() for t in tabs.values())
        print(f"{label}: tables {tab_bytes} bytes on the card, built in "
              f"{build_ms:.1f} ms, build peak {peak} bytes above the "
              f"{mem0} already held; "
              + ", ".join(f"{k} {tuple(t.shape)} {str(t.dtype)[6:]}"
                          for k, t in tabs.items()))

        def cascade(img=x):
            if packed:
                return tk.lut_cascade_packed(tabs, img, **cfg)
            return ens.lut_cascade_int(tabs, img, expanded=True, **cfg)

        def entry(batch):
            if ev is not None:
                return ev.upscale_batch(batch)
            chw = torch.from_numpy(np.ascontiguousarray(
                batch.transpose(0, 3, 1, 2))).to(dev)
            out = tk.unpack_u32(tk.lut_cascade_packed(tabs, chw, **cfg),
                                chw.shape[:-2], chw.shape[-2], chw.shape[-1],
                                scale)
            return out.transpose(0, 2, 3, 1)

        # every K1 call of the cascade against its plain version
        wf_calls, k2_calls = _record_calls(
            tk, ("window_fold_contract", "tail_assemble"), cascade)
        n_win = len(modes) * stages
        if len(wf_calls) != n_win or len(k2_calls) != int(packed):
            raise RuntimeError(f"{label}: recorded {len(wf_calls)} "
                               f"contraction and {len(k2_calls)} tail calls")
        labels = _window_labels(tk, wf_calls)
        wf_err, k1_err, bcalls = _k1_checks(torch, tk, wf_calls, labels,
                                            label)
        boundary += [b for b in bcalls if b[4] != 16]
        boundary_err = max(boundary_err, k1_err)
        k2 = None
        if packed:
            (folded, quads), kw2 = k2_calls[0]
            got = tk.tail_assemble(folded, quads, **kw2)
            bc, wp = int(np.prod(kw2["lead"])), tk._pad128(kw2["w"])
            plain_k2 = dict(bc=bc, h=kw2["h"], wp=wp, scale=scale,
                            davg=kw2["davg"])
            want = tk.tail_assemble_plain(folded, quads, **plain_k2)
            k2_err = (got.view(torch.uint8).int()
                      - want.view(torch.uint8).int()).abs().max().item()
            if not torch.equal(got, want):
                raise RuntimeError(f"{label}: tail_assemble differs: max abs "
                                   f"err {k2_err}")
            nmodes = len(folded) + len(quads)
            words = bc * kw2["h"] * scale * wp
            k2 = {"ms": _cuda_ms(torch, lambda: tk.tail_assemble(
                folded, quads, **kw2), 10),
                "plain_ms": _cuda_ms(torch, lambda: tk.tail_assemble_plain(
                    folded, quads, **plain_k2), 2),
                "bound_ms": words * (4 * 4 * nmodes * 4 + 4)
                / HBM_BYTES_PER_MS}
            print(f"{label}: tail_assemble ({len(folded)} folded, "
                  f"{len(quads)} quad modes) byte-equal to plain; "
                  + " ".join(f"{k}={v:.4f}" for k, v in k2.items()))
            del folded, quads, kw2, got, want
        del k2_calls

        # the entry point, counted
        want = {"gather_fold_contract": 0, "window_fold_contract": n_win,
                "tail_assemble": int(packed)}
        _reset(tk.LAUNCHES)
        with _plain_calls(tk, sx) as plain:
            t0 = time.perf_counter()
            out = entry(imgs)
            first_s = time.perf_counter() - t0
        launches = dict(tk.LAUNCHES)
        boundary_launches += launches["gather_fold_contract"]
        print(f"{label}: {'upscale_batch' if ev else 'lut_cascade_packed'} "
              f"{imgs.shape} -> {out.shape} {out.dtype}, launches {launches}, "
              f"plain contraction calls {plain}")
        if card and (launches != want or any(plain.values())):
            raise RuntimeError(f"{label}: launches {launches} and plain "
                               f"calls {plain}; expected {want} and none")
        if (out.shape != (BATCH, H * scale, W * scale, 3)
                or out.dtype != np.uint8):
            raise RuntimeError(f"{label}: bad output {out.shape} {out.dtype}")
        if label == "x4-rank":
            if ref16 is None:
                ref16 = LutEvaluator(lut3, **cfg, device=dev).upscale_batch(
                    imgs)
            if not np.array_equal(out, ref16):
                raise RuntimeError(
                    f"x4-rank: {int((out != ref16).sum())} bytes differ from "
                    "phase 5's 16-corner cascade")
            print("x4-rank: bytes equal to phase 5's 16-corner tables' "
                  "upscale_batch on the same batch and LUTs")
        del out
        # a crop: card against the port's CPU path
        t0 = time.perf_counter()
        if ev is not None:
            got = ev.upscale_batch(crop)
            ref = LutEvaluator(luts, **cfg, device="cpu").upscale_batch(crop)
        else:
            got = entry(crop)
            ctabs = ens.prepare_expanded_luts(luts, interval=interval,
                                              shared_quad=True, device="cpu")
            c = torch.from_numpy(np.ascontiguousarray(
                crop.transpose(0, 3, 1, 2)))
            ref = tk.unpack_u32(tk.lut_cascade_packed(ctabs, c, **cfg),
                                c.shape[:-2], CROP_H, CROP_W,
                                scale).transpose(0, 2, 3, 1)
            del ctabs
        if not np.array_equal(got, ref):
            raise RuntimeError(f"{label}: crop {crop.shape}: "
                               f"{int((got != ref).sum())} bytes differ from "
                               "the CPU path")
        print(f"{label}: crop {crop.shape} byte-equal to the port's CPU "
              f"path ({time.perf_counter() - t0:.1f} s with the CPU build)")

        # timings
        dev_ms = _cuda_ms(torch, cascade, 5)
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            entry(imgs)
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        mpix = mpix_per * scale * scale
        k1, _ = _window_timings(torch, tk, wf_calls, labels, label)
        print(f"{label}: cascade on the card (CUDA events) {dev_ms:.3f} ms "
              f"per batch = {mpix / dev_ms * 1e3:.2f} MPix/s; its K1 calls "
              f"{k1['ms']:.3f} ms"
              + (f", K2 {k2['ms']:.3f} ms" if k2 else "")
              + f", the rest (torch glue: pads, un-shift adds, stage mixes"
              + (", interleave" if not packed else "") + ", launches) "
              f"{dev_ms - k1['ms'] - (k2['ms'] if k2 else 0.0):.3f} ms")
        print(f"{label}: {'upscale_batch' if ev else 'lut_cascade_packed'}"
              f" (host clock, H2D + D2H included) {host_ms:.3f} ms per "
              f"batch = {mpix / host_ms * 1e3:.2f} MPix/s (first call "
              f"{first_s * 1e3:.1f} ms)")
        if card and not packed:
            _profile(torch, cascade, dev_ms, top=10, what=f"{label} cascade")
        entries.append({
            "name": f"window_fold_contract_{label.replace('-', '_')}",
            "route": "cuda", "source": SOURCE_K1W, "replaces": REPLACES_K1,
            "launches": launches["window_fold_contract"],
            "max_abs_err": wf_err,
            "ms": k1["ms"], "plain_ms": k1["plain_ms"],
            "bound_ms": k1["bound_ms"], "bound_by": "bytes",
            "library_ms": None})
        if label == "x4-sdyeho":
            entries.append({
                "name": "tail_assemble_x4_sdyeho", "route": "cuda",
                "source": SOURCE_K2, "replaces": REPLACES_K2,
                "launches": launches["tail_assemble"], "max_abs_err": k2_err,
                "ms": k2["ms"], "plain_ms": k2["plain_ms"],
                "bound_ms": k2["bound_ms"], "bound_by": "bytes",
                "library_ms": None})
        if label == "x4-rank":
            _lut_yuv(torch, tk, lut3, imgs, crop, dev)
        del ev, tabs, wf_calls
        torch.cuda.empty_cache()

    b = _boundary_timings(torch, tk, boundary)
    entries.append({
        "name": "gather_fold_contract_rank", "route": "cuda",
        "source": SOURCE_K1, "replaces": REPLACES_K1,
        "launches": boundary_launches, "max_abs_err": boundary_err,
        "ms": b["ms"], "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"], "bound_by": "bytes",
        "library_ms": b["library_ms"]})
    del boundary
    torch.cuda.empty_cache()
    return entries


def _lut_yuv(torch, tk, luts, imgs, crop, dev):
    """`LutEvaluator.upscale_yuv_batch` on phase 3's LUTs (x4 sdy, the
    packed path): launches counted on the batch, the crop card vs CPU,
    host ms."""
    from mulut_tpu_torch.pipelines.evaluate import LutEvaluator

    cfg = dict(stages=STAGES, modes=MODES, scale=SCALE, interval=INTERVAL)
    ev = LutEvaluator(luts, **cfg, device=dev)
    want = {"gather_fold_contract": 0, "window_fold_contract": 6,
            "tail_assemble": 1}
    _reset(tk.LAUNCHES)
    out = ev.upscale_yuv_batch(imgs)
    launches = dict(tk.LAUNCHES)
    print(f"upscale_yuv_batch: {imgs.shape} -> {out.shape} {out.dtype}, "
          f"launches {launches}")
    if ((dev.type == "cuda" and launches != want)
            or out.shape != (BATCH, H * SCALE, W * SCALE, 3)):
        raise RuntimeError(f"upscale_yuv_batch: launches {launches}, "
                           f"expected {want}; output {out.shape}")
    got = ev.upscale_yuv_batch(crop)
    ref = LutEvaluator(luts, **cfg, device="cpu").upscale_yuv_batch(crop)
    if not np.array_equal(got, ref):
        raise RuntimeError(f"upscale_yuv_batch crop: {int((got != ref).sum())}"
                           " bytes differ from the CPU path")
    print(f"upscale_yuv_batch: crop {crop.shape} byte-equal to the CPU path")
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        ev.upscale_yuv_batch(imgs)
    ms = (time.perf_counter() - t0) * 1e3 / reps
    mpix = BATCH * H * SCALE * W * SCALE / 1e6
    print(f"upscale_yuv_batch (host clock, H2D + D2H included): {ms:.3f} ms "
          f"per batch = {mpix / ms * 1e3:.2f} MPix/s")


#: Phase 16 (`_parallel`): how the port cuts an image or a batch.  A 4K
#: and an 8K LR frame (3 x H x W, structured, seed 16) through the banded
#: cascade (BAND_ROWS rows per band); band + bucket on MANY_SIZES frames;
#: SHARDS row or batch shards of the card (`make_mesh(SHARDS, ["cuda:0"] *
#: SHARDS)`); the net-mode batch of NET_SHARD_BATCH frames; data-parallel
#: steps on DP_SHARDS shards at phase 13's reference width.
FRAME_4K, FRAME_8K, BAND_ROWS = (2160, 3840), (4320, 7680), 256
MANY_SIZES = [(1100, 1900), (1080, 1440), (720, 1280), (1000, 1900),
              (540, 960), (333, 500)]
MANY_BUCKET, MANY_BAND = 64, 128
SHARDS, NET_SHARD_BATCH, DP_SHARDS = 4, 7, 2
#: rows each side of a sampled 8K band that its independent check reads
BAND_CHECK_MARGIN = 64
#: the 2-shard fine-tune step's float32 gradients against one device's,
#: relative to each tensor's max: the split changes the order of the
#: stage-2 tables' float32 sums (read 3.853e-06-3.984e-06 on the `_ftr2`
#: tables, 1.459e-06-1.511e-06 on random ones); with every value in
#: float64 the split and unsplit gradients and losses agree to
#: DP_F64_REL (a wrong shard weight or a lost shard is off by O(1))
DP_FT_GRAD_REL, DP_F64_REL = 2e-5, 1e-12


def _frame(rng, h, w):
    """A structured (H, W, 3) uint8 frame (`data.synthetic._synth_image`,
    as phase 13's frames)."""
    from mulut_tpu_torch.data.synthetic import _synth_image

    return _synth_image(rng, max(h, w))[:h, :w]


def _peak_ms(torch, fn, reps, card):
    """`fn()`'s peak device memory (GiB, everything resident included; not
    measured on the CPU) and its device ms over `reps` calls."""
    peak = None
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fn()
    if card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return peak, _cuda_ms(torch, fn, reps)


def _gib(peak):
    return "not measured (CPU)" if peak is None else f"{peak:.3f} GiB"


def _counted(torch, tk, uk, sx, run):
    """`run()` with every launch counter set to 0 just before and read
    just after, and the plain contraction bodies counted: (result, K1/K2
    launches, unit-kernel launches, plain calls)."""
    _reset(tk.LAUNCHES, uk.LAUNCHES)
    with _plain_calls(tk, sx) as plain:
        out = run()
    return out, dict(tk.LAUNCHES), dict(uk.LAUNCHES), dict(plain)


def _lut_launch_gate(what, card, launches, plain, window, tail):
    print(f"{what}: launches {launches}, plain contraction calls {plain}")
    want = {"gather_fold_contract": 0, "window_fold_contract": window,
            "tail_assemble": tail}
    if card and (launches != want or any(plain.values())):
        raise RuntimeError(f"{what}: launches {launches} and plain calls "
                           f"{plain}; expected {want} and none")


def _parallel(torch, tk, imgs, *, dev="cuda"):
    """Phase 16: the banded cascade, band + bucket, the row- and
    batch-sharded paths and the data-parallel steps on the card (module
    docstring).  `dev` exists for a rehearsal on the CPU at a small size
    (module constants shrunk, `_cuda_ms` and the `torch.cuda` calls
    stubbed); the card run takes the default."""
    import tempfile

    from mulut_tpu_torch.data import DIV2K
    from mulut_tpu_torch.dryrun import STEP_ATOL, dryrun_multidevice
    from mulut_tpu_torch.models import lut_model as lm
    from mulut_tpu_torch.models.srnet import init_srnets, srnets_predict_fast
    from mulut_tpu_torch.models.torch_import import load_params_npz
    from mulut_tpu_torch.ops import ensemble as ens
    from mulut_tpu_torch.ops import simplex as sx
    from mulut_tpu_torch.ops import unit_kernel as uk
    from mulut_tpu_torch.parallel import (
        cascade_row_sharded,
        data_parallel_grads,
        make_mesh,
        net_row_sharded,
        replicate_tree,
        tree_leaves,
    )
    ftm = importlib.import_module("mulut_tpu_torch.pipelines.finetune")
    trm = importlib.import_module("mulut_tpu_torch.pipelines.train")
    from mulut_tpu_torch.pipelines import transfer as tfm
    from mulut_tpu_torch.pipelines.evaluate import LutEvaluator, NetEvaluator

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    card = dev.type == "cuda"
    ncfg = dict(stages=STAGES, modes=MODES, scale=SCALE)
    cfg = dict(ncfg, interval=INTERVAL)
    luts = _random_luts(np.random.default_rng(0), INTERVAL)   # phase 3's
    rng = np.random.default_rng(16)
    halo = ens.cascade_halo(STAGES, MODES)

    # 16.1 the 4K frame: banded against untiled
    h4, w4 = FRAME_4K
    frame = _frame(rng, h4, w4)
    slabs4 = len(ens.slab_bounds(h4, BAND_ROWS, halo)[1])
    banded = LutEvaluator(luts, band=BAND_ROWS, device=dev, **cfg)
    untiled = LutEvaluator(luts, max_batch_pixels=3 * h4 * w4, device=dev,
                           **cfg)
    x4 = torch.from_numpy(np.ascontiguousarray(frame.transpose(2, 0, 1))).to(
        dev)
    read = {}
    for name, ev, window, tail in (("banded", banded, 6 * slabs4, slabs4),
                                   ("untiled", untiled, 6, 1)):
        out, launches, _, plain = _counted(torch, tk, uk, sx,
                                           lambda: ev.upscale(frame))
        _lut_launch_gate(f"4K {name} upscale {frame.shape}", card, launches,
                         plain, window, tail)
        peak, ms = _peak_ms(torch, lambda: ev._cascade(x4), 3, card)
        read[name] = (out, peak, ms)
        print(f"4K {name}: {ms:.3f} ms on the card (CUDA events), peak "
              f"memory {_gib(peak)}, output {out.shape} {out.dtype}")
    if not np.array_equal(read["banded"][0], read["untiled"][0]):
        raise RuntimeError("4K: banded and untiled differ in "
                           f"{int((read['banded'][0] != read['untiled'][0]).sum())}"
                           " bytes")
    ratio = read["banded"][2] / read["untiled"][2]
    print(f"4K band={BAND_ROWS}: bytes equal to the untiled cascade; "
          f"{slabs4} slabs; banded/untiled ms {ratio:.4f}")
    ref4 = read["untiled"][0]
    peak4 = read["untiled"][1]
    del read, untiled
    if card:
        torch.cuda.empty_cache()

    # 16.2 the 8K frame, banded only
    h8, w8 = FRAME_8K
    frame8 = _frame(rng, h8, w8)
    x8 = torch.from_numpy(np.ascontiguousarray(frame8.transpose(2, 0, 1))).to(
        dev)
    slab_h, bounds8 = ens.slab_bounds(h8, BAND_ROWS, halo)
    out8, launches, _, plain = _counted(torch, tk, uk, sx,
                                        lambda: banded._cascade(x8))
    _lut_launch_gate(f"8K banded {tuple(x8.shape)}", card, launches, plain,
                     6 * len(bounds8), len(bounds8))
    peak8, ms8 = _peak_ms(torch, lambda: banded._cascade(x8), 2, card)
    mpix8 = h8 * SCALE * w8 * SCALE / 1e6
    print(f"8K banded: {ms8:.3f} ms on the card (CUDA events) = "
          f"{mpix8 / ms8 * 1e3:.2f} MPix/s, {len(bounds8)} slabs of {slab_h} "
          f"rows, peak memory {_gib(peak8)} (4K untiled {_gib(peak4)})")
    if card and not peak8 < peak4:
        raise RuntimeError("8K banded peak memory is not below the 4K "
                           "untiled peak")
    for i in (0, len(bounds8) // 2, len(bounds8) - 1):
        kept0 = bounds8[i][0]
        lo = max(0, kept0 - BAND_CHECK_MARGIN)
        hi = min(h8, kept0 + BAND_ROWS + BAND_CHECK_MARGIN)
        ref = banded._untiled(x8[:, lo:hi])
        ref = ref[:, (kept0 - lo) * SCALE:(kept0 - lo + BAND_ROWS) * SCALE]
        got = out8[:, kept0 * SCALE:(kept0 + BAND_ROWS) * SCALE]
        if not torch.equal(got, ref):
            raise RuntimeError(f"8K band {i} (rows {kept0}-"
                               f"{kept0 + BAND_ROWS}) differs from the "
                               "untiled cascade")
        print(f"8K band {i} (rows {kept0}-{kept0 + BAND_ROWS}): bytes equal "
              f"to the untiled cascade on rows {lo}-{hi}")
    del out8, x8, frame8
    if card:
        torch.cuda.empty_cache()

    # 16.3 band with bucket
    frames = [_frame(rng, h, w) for h, w in MANY_SIZES]
    both = LutEvaluator(luts, bucket=MANY_BUCKET, band=MANY_BAND, device=dev,
                        **cfg)
    bucketed = LutEvaluator(luts, bucket=MANY_BUCKET, device=dev, **cfg)
    t0 = time.perf_counter()
    got, launches, _, plain = _counted(torch, tk, uk, sx,
                                       lambda: both.upscale_many(frames))
    t_both = (time.perf_counter() - t0) * 1e3
    print(f"band {MANY_BAND} + bucket {MANY_BUCKET}, {len(frames)} frames up "
          f"to {max(MANY_SIZES)}: launches {launches}, plain contraction "
          f"calls {plain}, {t_both:.1f} ms (host clock, one call)")
    if card and (not launches["window_fold_contract"]
                 or not launches["tail_assemble"] or any(plain.values())):
        raise RuntimeError("band + bucket: K1 or K2 not launched, or a "
                           "plain contraction ran")
    t0 = time.perf_counter()
    want = bucketed.upscale_many(frames)
    t_bucket = (time.perf_counter() - t0) * 1e3
    for i, (g, w_) in enumerate(zip(got, want)):
        if not np.array_equal(g, w_):
            raise RuntimeError(f"band + bucket: frame {i} {frames[i].shape} "
                               "differs from bucket alone")
    print(f"band + bucket: bytes equal to bucket alone ({t_bucket:.1f} ms, "
          "host clock, one call)")
    del both, bucketed, got, want, frames

    # 16.4 the row-sharded cascade
    mesh = make_mesh(SHARDS, [dev] * SHARDS)
    xb = torch.from_numpy(np.ascontiguousarray(imgs.transpose(0, 3, 1, 2))).to(
        dev)
    for what, x, want in (("bench batch", xb, None), ("4K frame", x4, ref4)):
        got, launches, _, plain = _counted(
            torch, tk, uk, sx, lambda: cascade_row_sharded(
                mesh, banded.luts, x, expanded=True, **cfg))
        _lut_launch_gate(f"row-sharded {what} {tuple(x.shape)} over "
                         f"{SHARDS} shards", card, launches, plain,
                         6 * SHARDS, SHARDS)
        if want is None:
            want = banded._untiled(x)
        else:
            want = torch.from_numpy(want.transpose(2, 0, 1)).to(dev)
        if not torch.equal(got, want):
            raise RuntimeError(f"row-sharded {what}: "
                               f"{int((got != want).sum())} bytes differ from "
                               "the unsharded cascade")
        def sharded():
            return cascade_row_sharded(mesh, banded.luts, x, expanded=True,
                                       **cfg)

        ms = _cuda_ms(torch, sharded, 3)
        ms1 = _cuda_ms(torch, lambda: banded._untiled(x), 3)
        print(f"row-sharded {what}: bytes equal to the unsharded packed "
              f"cascade; {ms:.3f} ms on one card in {SHARDS} shards "
              f"(unsharded {ms1:.3f})")
        if card and what == "bench batch":
            _profile(torch, sharded, ms, top=8,
                     what=f"row-sharded {what}")
    del banded, x4, ref4
    if card:
        torch.cuda.empty_cache()

    # 16.5 net-mode shards on the _ftr2 weights (K3)
    params = load_params_npz(NET_WEIGHTS)
    one = NetEvaluator(params, fast=True, device=dev, **ncfg)
    xf = xb.float() / 255.0
    got, _, ulaunch, _ = _counted(torch, tk, uk, sx, lambda: net_row_sharded(
        mesh, None, xf, fast_stacked=one.stacked, **ncfg))
    _k3_gate("net_row_sharded", card, ulaunch, 2 * SHARDS)
    want = srnets_predict_fast(one.stacked, xf, **ncfg)
    _net_equal(torch, "net_row_sharded", got, want)
    many = NetEvaluator(params, fast=True, device=mesh, **ncfg)
    sub = imgs[:NET_SHARD_BATCH]
    for entry in ("upscale_batch", "upscale_yuv_batch"):
        got, _, ulaunch, _ = _counted(torch, tk, uk, sx,
                                      lambda: getattr(many, entry)(sub))
        _k3_gate(f"NetEvaluator({SHARDS} shards).{entry} B={len(sub)}", card,
                 ulaunch, 2 * SHARDS)
        want = getattr(one, entry)(sub)
        _net_equal(torch, f"NetEvaluator({SHARDS} shards).{entry}",
                   torch.from_numpy(got), torch.from_numpy(want))
    del one, many, xf, xb

    # 16.6 data-parallel steps on DP_SHARDS shards, phase 13's setup: the
    # reference width, and the _ftr2 units' tables to fine-tune
    mesh2 = make_mesh(DP_SHARDS, [dev] * DP_SHARDS)
    with tempfile.TemporaryDirectory() as root:
        _synthetic_div2k(root, images=TRAIN["images"], hr=TRAIN["hr"])
        im, lb = DIV2K(SCALE, root, TRAIN["crop"], seed=0).sample_batch(
            TRAIN["batch"])
    im, lb = torch.from_numpy(im).to(dev), torch.from_numpy(lb).to(dev)
    net = init_srnets(np.random.default_rng(0), nf=TRAIN["nf"], arch="dense",
                      **ncfg)

    def tables_of(arrays):
        w = lm.init_lut_weights_from_arrays(arrays, upscale=SCALE,
                                            device=dev, modes=MODES,
                                            stages=STAGES)
        for t in w.values():
            t.requires_grad_(True)
        return w

    def step_io(make, tree, m):
        """One step of `make(optimizer, m)` from a copy of `tree` on the
        mesh `m` (its first device holding the batch): (loss, grads) and
        the updated leaves."""
        reps = replicate_tree(m, tree)
        leaves = tree_leaves(reps[0])
        step = make(trm.make_optimizer(leaves, 1e-3, 1e-4, 100), m)
        loss = float(step(reps if len(m) > 1 else reps[0], im.to(m[0]),
                          lb.to(m[0])))
        return ((loss, {i: t.grad.cpu() for i, t in enumerate(leaves)}),
                [t.detach().cpu() for t in leaves])

    # i / 255 in float64 by the host's true division: the cascade's
    # `x * 255` gives each pixel back exactly (the card divides by a
    # scalar as a multiply by its reciprocal, which misses 24 of the 256
    # and leaves each tie of the stage mix to the order of a sum)
    unit64 = (torch.arange(256, dtype=torch.float64) / 255.0).to(dev)

    def loss64(w, im, lb):
        """The fine-tune loss with every value in float64."""
        pred = lm.lut_model_forward(w, unit64[im.long()], modes=MODES,
                                    stages=STAGES, upscale=SCALE,
                                    interval=INTERVAL, device=im.device)
        return torch.mean((pred - unit64[lb.long()]) ** 2)

    def grads64(tree, m):
        """(loss, grads) of `loss64` on a float64 copy of `tree` through
        `data_parallel_grads` over the mesh `m`."""
        reps = replicate_tree(m, {k: t.detach().double().requires_grad_(True)
                                  for k, t in tree.items()})
        loss = data_parallel_grads(m, reps, loss64, im.to(m[0]), lb.to(m[0]))
        return float(loss), {i: t.grad.cpu() for i, t in
                             enumerate(tree_leaves(reps[0]))}

    def ft_make(o, m):
        return ftm.make_finetune_step(o, upscale=SCALE, interval=INTERVAL,
                                      mesh=m, modes=MODES, stages=STAGES)

    names = (f"{DP_SHARDS} shards", "one device")
    host2 = [torch.device("cpu")] * DP_SHARDS
    ftr2 = tfm.transfer_to_luts(params, modes=MODES, stages=STAGES,
                                interval=INTERVAL, device=dev)
    for what, tree, loss_rel, grad_rel, make in (
            ("train step", trm.trainable(net, dev), TRAIN_LOSS_REL,
             TRAIN_GRAD_REL, lambda o, m: trm.make_train_step(
                 o, mesh=m, **ncfg)),
            ("fine-tune step, _ftr2 tables", tables_of(ftr2), FT_LOSS_REL,
             DP_FT_GRAD_REL, ft_make)):
        (shards, p_shards), (one, p_one) = (step_io(make, tree, mesh2),
                                            step_io(make, tree, mesh2[:1]))
        _grad_gate(f"{what}, one device again vs first",
                   step_io(make, tree, mesh2[:1])[0], one, None, None,
                   ("again", "first"))
        _grad_gate(f"{what}, {names[0]} vs {names[1]}", shards, one,
                   loss_rel, grad_rel, names)
        if "fine-tune" in what:
            _grad_gate(f"{what}, {names[0]}: card vs CPU",
                       shards, step_io(make, tree, host2)[0], FT_LOSS_REL,
                       FT_GRAD_REL)
            _grad_gate(f"{what} in float64, {names[0]} vs {names[1]}",
                       grads64(tree, mesh2), grads64(tree, mesh2[:1]),
                       DP_F64_REL, DP_F64_REL, names)
        off = max(float((a - b).abs().max()) for a, b in zip(p_shards, p_one))
        print(f"{what}: params after the step, {names[0]} vs {names[1]}: "
              f"max |diff| {off:.3e} (gate {STEP_ATOL})")
        if not off <= STEP_ATOL:
            raise RuntimeError(f"{what}: updated params depart")
    # readings on phase 3's random tables (loss ~0.3, far from trained)
    rand = tables_of(luts)
    _grad_gate(f"fine-tune step, random tables, {names[0]} vs {names[1]}",
               step_io(ft_make, rand, mesh2)[0],
               step_io(ft_make, rand, mesh2[:1])[0], None, None, names)
    del params

    # 16.7 the dry run
    done = dryrun_multidevice(SHARDS, [dev] * SHARDS)
    print(f"dryrun_multidevice({SHARDS}, [{str(dev)!r}] * {SHARDS}): "
          + "; ".join(done))
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s")


#: Phase 17 (`_tasks`): distillation and the non-SR tasks at full width,
#: only the iterations cut.  Distillation: dense teachers (phase 13's
#: trained units when it ran, else `init_srnets` seed 0: nf=64, depth 4,
#: x4 `sdy`, 2 stages) into plain students of nf=128, depth 2, on 65,536
#: taps per step at interval 4, `distill_steps` steps per unit; then the
#: image-space pass, `cascade_steps` steps of 16 crops of 48^2.  Denoise:
#: dense nf=64 `sdy` 2-stage x1 cascade, `task_steps` steps of 32 x 1 x
#: 48 x 48 at sigma 15, deployed on one 1080 x 1920 x 3 frame (`_frame`,
#: seed 17) plus noise; demosaic: the nf=64 unit, `task_steps` steps of
#: 32 x 48 x 48 x 3, deployed on that frame's mosaic.  The crop is the
#: card-vs-CPU window of the deployments.
TASKS = dict(teacher_nf=64, student_nf=128, student_depth=2, taps=65536,
             distill_steps=300, cascade_steps=10, cascade_batch=16,
             cascade_crop=48, task_nf=64, task_batch=32, task_crop=48,
             task_steps=20, sigma=15.0, frame=(1080, 1920),
             crop=(CROP_H, CROP_W))


def _task_crops(rng, n, batch, crop, *, rgb):
    """`n` uint8 batches of `crop`^2 crops of 8 structured 192^2 images
    (`data.synthetic._synth_image`): (batch, crop, crop, 3) with `rgb`,
    else one random channel, (batch, 1, crop, crop)."""
    from mulut_tpu_torch.data.synthetic import _synth_image

    pool = [_synth_image(rng, 192) for _ in range(8)]
    out = []
    for _ in range(n):
        ims = []
        for _ in range(batch):
            im = pool[rng.integers(len(pool))]
            y, x = rng.integers(0, 192 - crop + 1, 2)
            patch = im[y: y + crop, x: x + crop]
            ims.append(patch if rgb else patch[None, :, :, rng.integers(3)])
        out.append(np.ascontiguousarray(np.stack(ims)))
    return out


def _unit_macs(unit):
    """Multiply-adds per tap vector of one unit (its weight matrices)."""
    return sum(int(np.prod(t.shape)) for n, t in unit.items() if n[0] == "w")


def _tasks(torch, tk, imgs, teachers=None, *, dev="cuda"):
    """Phase 17: distillation and the non-SR tasks on the card (module
    docstring); `teachers` are phase 13's trained dense units.  Returns
    the K3 (students) and K1 (x1 cascade) entries of the kernels line.
    `dev` exists for a rehearsal on the CPU at a small size (TASKS and
    the image constants shrunk, `_cuda_ms` and the `torch.cuda` calls
    stubbed); the card run takes the default."""
    from mulut_tpu_torch.models.srnet import init_srnets
    from mulut_tpu_torch.models.torch_import import (
        params_from_numpy,
        params_to_numpy,
    )
    from mulut_tpu_torch.ops import ensemble as ens
    from mulut_tpu_torch.ops import simplex as sx
    from mulut_tpu_torch.ops import unit_kernel as uk
    from mulut_tpu_torch.pipelines import distill as dsm
    from mulut_tpu_torch.pipelines import tasks as tsk
    trm = importlib.import_module("mulut_tpu_torch.pipelines.train")
    from mulut_tpu_torch.pipelines.evaluate import LutEvaluator, NetEvaluator
    from mulut_tpu_torch.pipelines.transfer import transfer_to_luts
    from mulut_tpu_torch.utils.metrics import psnr

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    card = dev.type == "cuda"
    size = TASKS
    cfg = dict(stages=STAGES, modes=MODES, scale=SCALE)
    ch, cw = size["crop"]
    print(f"phase 17 on {_card() if card else 'the CPU (rehearsal)'}; cut: "
          f"{size['distill_steps']} distillation steps per unit (4,000 by "
          f"default), {size['cascade_steps']} image-space steps (2,000), "
          f"{size['task_steps']} denoise and demosaic steps (100)")

    # 17.1 distillation
    if teachers is None:
        teachers = init_srnets(np.random.default_rng(0),
                               nf=size["teacher_nf"], arch="dense", **cfg)
        print("distillation: teachers are seed-0 dense units (phase 13 did "
              "not run)")
    else:
        print("distillation: teachers are phase 13's trained dense units")
    teachers = params_to_numpy(params_from_numpy(teachers, "cpu"))
    rec, restore = _timed_steps(torch, dsm, "make_distill_step", dev)
    t0 = time.perf_counter()
    try:
        students, metrics = dsm.distill_srnets(
            teachers, nf=size["student_nf"], depth=size["student_depth"],
            iters=size["distill_steps"], batch=size["taps"],
            interval=INTERVAL, device=dev, **cfg)
    finally:
        restore()
    wall = time.perf_counter() - t0
    for name, m in metrics.items():
        print(f"distill {name}: final batch mse {m['final_batch_mse']:.4e}, "
              f"lattice mse {m['lattice_mse']:.4e}, max |err| "
              f"{m['lattice_max_abs']:.4f} ({m['lattice_max_levels']:.2f} "
              "LUT levels)")
    s2 = f"s{STAGES}_{MODES[0]}"
    flops = 2 * size["taps"] * (_unit_macs(teachers[s2])
                                + 3 * _unit_macs(students[s2]))
    med = _step_readings(torch, rec, "distill_unit steps (final stage)",
                         flops)
    print(f"distill_srnets: {len(students)} units, {wall:.1f} s (host "
          "clock, lattice metrics included)")
    if card:        # one final-stage step, on a copy of its student
        p = trm.trainable({"u": students[s2]}, dev)["u"]
        teacher = params_from_numpy({"u": teachers[s2]}, dev)["u"]
        step = dsm.make_distill_step(trm.make_optimizer(
            [p[k] for k in sorted(p)], 2e-3, 1e-5, 100), teacher)
        gen = torch.Generator(device=dev).manual_seed(0)
        lattice = torch.as_tensor(dsm.transfer_lattice(INTERVAL), device=dev)
        _profile(torch, lambda: step(p, dsm.sample_taps(
            gen, size["taps"], lattice=lattice)), med, top=8,
            what="distill step")
        del p, teacher, step
    rec, restore = _timed_steps(torch, dsm, "make_cascade_distill_step", dev)
    try:
        students, losses = dsm.distill_finetune_cascade(
            students, teachers, iters=size["cascade_steps"],
            batch=size["cascade_batch"], crop=size["cascade_crop"],
            device=dev, **cfg)
    finally:
        restore()
    px = size["cascade_batch"] * size["cascade_crop"] ** 2
    macs = sum(_unit_macs(teachers[f"s{s + 1}_{m}"])
               + 3 * _unit_macs(students[f"s{s + 1}_{m}"])
               for s in range(STAGES) for m in MODES)
    med = _step_readings(torch, rec, "distill_finetune_cascade",
                         2 * 4 * px * macs)
    if card:        # one step, on copies of the students
        p = trm.trainable(students, dev)
        step = dsm.make_cascade_distill_step(
            trm.make_optimizer(trm.param_leaves(p), 2e-4, 1e-6, 100),
            params_from_numpy(teachers, dev), **cfg)
        x = torch.rand((size["cascade_batch"], 1, size["cascade_crop"],
                        size["cascade_crop"]), device=dev)
        _profile(torch, lambda: step(p, x), med, top=8,
                 what="image-space distillation step")
        del p, step, x

    # 17.2 serve the students: net mode (K3) and their cached tables (K1, K2)
    ev = NetEvaluator(students, fast=True, device=dev, **cfg)
    (calls,) = _record_calls(uk, ("stage_ensemble_apply_w",),
                             lambda: ev.upscale_batch(imgs))
    if len(calls) != 2:
        raise RuntimeError(f"students: recorded {len(calls)} K3 calls, "
                           "expected 2")
    k3_err = 0.0
    for site, (args, kw) in zip(("s1 inner", "s2 final"), calls):
        for mix in [None] + ([kw["mix"]] if kw.get("mix") else []):
            got = uk.stage_ensemble_apply_w(*args, **dict(kw, mix=mix))
            want = uk.stage_ensemble_apply_w_plain(*args, **{
                k: v for k, v in dict(kw, mix=mix).items() if k != "v"})
            if card:
                torch.cuda.synchronize()
            k3_err = max(k3_err, _gate(
                f"students K3 {site} {'raw acc' if mix is None else mix} "
                f"{tuple(got.shape)}", _differ(torch, got, want, mix),
                RAW_ABS if mix is None else MIX_ABS))
    out, launches, ulaunch, _ = _counted(torch, tk, uk, sx,
                                         lambda: ev.upscale_batch(imgs))
    _k3_gate(f"students NetEvaluator(fast=True).upscale_batch {imgs.shape}",
             card, ulaunch, 2)
    if any(launches.values()):
        raise RuntimeError(f"students net mode launched LUT kernels "
                           f"{launches}")
    k3_launches = ulaunch["stage_ensemble_apply_w"]
    crop = np.ascontiguousarray(imgs[0, :ch, :cw])
    _u8_gate(f"students net {ch}x{cw} crop, card vs CPU path",
             ev.upscale(crop), NetEvaluator(students, fast=True,
                                            device="cpu", **cfg).upscale(crop))
    t0 = time.perf_counter()
    ev.upscale_batch(imgs)
    print(f"students net upscale_batch (host clock): "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    k3 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for site, (args, kw) in zip(("s1 inner", "s2 final"), calls):
        n, fl, nbytes = _k3_work(args[0], args[1], kw)
        pkw = {k: v for k, v in kw.items() if k != "v"}
        t = {"ms": _cuda_ms(torch, lambda: uk.stage_ensemble_apply_w(
                 *args, **kw), 10),
             "plain_ms": _cuda_ms(torch, lambda: uk.stage_ensemble_apply_w_plain(
                 *args, **pkw), 2),
             "bound_ms": max(fl / BF16_FLOPS_PER_MS,
                             nbytes / HBM_BYTES_PER_MS)}
        for k in k3:
            k3[k] += t[k]
        print(f"students K3 {site}: image sites={n} "
              + " ".join(f"{k}={v:.4f}" for k, v in t.items()))
    del ev, calls
    tables = transfer_to_luts(students, modes=MODES, stages=STAGES,
                              interval=INTERVAL, device=dev)
    lev = LutEvaluator(tables, interval=INTERVAL, device=dev, **cfg)
    out, launches, ulaunch, plain = _counted(
        torch, tk, uk, sx, lambda: lev.upscale_batch(imgs))
    _lut_launch_gate(f"students' tables LutEvaluator.upscale_batch "
                     f"{imgs.shape}", card, launches, plain, 6, 1)
    crops = np.ascontiguousarray(imgs[:2, :ch, :cw])
    got = lev.upscale_batch(crops)
    want = LutEvaluator(tables, interval=INTERVAL, device="cpu",
                        **cfg).upscale_batch(crops)
    if not np.array_equal(got, want):
        raise RuntimeError(f"students' tables: {int((got != want).sum())} "
                           "bytes differ from the CPU path")
    print(f"students' tables: crop {crops.shape} byte-equal to the CPU path")
    del lev, tables
    if card:
        torch.cuda.empty_cache()

    # 17.3 denoise
    rng = np.random.default_rng(17)
    batches = _task_crops(rng, size["task_steps"], size["task_batch"],
                          size["task_crop"], rgb=False)
    rec, restore = _timed_steps(torch, tsk, "make_dn_train_step", dev)
    try:
        dn, losses = tsk.train_dn(iter(batches), nf=size["task_nf"],
                                  iters=size["task_steps"], device=dev,
                                  modes=MODES, stages=STAGES)
    finally:
        restore()
    px = size["task_batch"] * size["task_crop"] ** 2
    macs = sum(_unit_macs(u) for u in dn.values())
    _step_readings(torch, rec, f"train_dn (sigma {size['sigma']:g})",
                   3 * 2 * 4 * px * macs)
    luts = tsk.dn_transfer(dn, modes=MODES, stages=STAGES,
                           interval=INTERVAL, device=dev)
    want = tsk.dn_transfer(dn, modes=MODES, stages=STAGES,
                           interval=INTERVAL, device="cpu")
    for k in sorted(luts):
        d = np.abs(luts[k].astype(int) - want[k].astype(int))
        if luts[k].shape != ((2 ** (8 - INTERVAL) + 1) ** 4, 1) or \
                d.max() > 1 or (d > 0).sum() > CACHE_FLIP_SHARE * d.size:
            raise RuntimeError(f"dn_transfer {k}: {luts[k].shape}, "
                               f"{int((d > 0).sum())} entries off the CPU "
                               "path")
    print(f"dn_transfer: {len(luts)} tables {luts[sorted(luts)[0]].shape} "
          "int8, tie flips against the CPU path "
          f"{sum(int((luts[k] != want[k]).sum()) for k in luts)}")
    fh, fw = size["frame"]
    frame = _frame(rng, fh, fw)
    noisy = tsk.add_gaussian_noise(frame, size["sigma"], rng)
    run = dict(modes=MODES, stages=STAGES, interval=INTERVAL, device=dev)
    (wf_calls,) = _record_calls(tk, ("window_fold_contract",),
                                lambda: tsk.dn_lut_apply(luts, noisy, **run))
    labels = [f"s{s + 1}_{m} " + lab for (s, m), lab in zip(
        [(s, m) for s in range(STAGES) for m in MODES],
        _window_labels(tk, wf_calls))]
    wf_err, _, _ = _k1_checks(torch, tk, wf_calls, labels, "dn_lut_apply")
    den, launches, ulaunch, plain = _counted(
        torch, tk, uk, sx, lambda: tsk.dn_lut_apply(luts, noisy, **run))
    _lut_launch_gate(f"dn_lut_apply {noisy.shape}", card, launches, plain,
                     len(labels), 0)
    if any(ulaunch.values()) or den.shape != frame.shape:
        raise RuntimeError(f"dn_lut_apply: {den.shape}, unit launches "
                           f"{ulaunch}")
    k1_launches = launches["window_fold_contract"]
    c = np.ascontiguousarray(noisy[:ch, :cw])
    got = tsk.dn_lut_apply(luts, c, **run)
    want = tsk.dn_lut_apply(luts, c, **dict(run, device="cpu"))
    if not np.array_equal(got, want):
        raise RuntimeError(f"dn_lut_apply crop: {int((got != want).sum())} "
                           "bytes differ from the CPU path")
    print(f"dn_lut_apply: crop {c.shape} byte-equal to the CPU path")
    t0 = time.perf_counter()
    for _ in range(3):
        tsk.dn_lut_apply(luts, noisy, **run)
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    tabs = ens.prepare_expanded_luts(luts, interval=INTERVAL, device=dev)
    x = torch.from_numpy(np.ascontiguousarray(noisy.astype(
        np.int32).transpose(2, 0, 1))).to(dev)

    def cascade():
        return ens.lut_cascade_int(tabs, x, stages=STAGES, modes=MODES,
                                   scale=1, interval=INTERVAL, expanded=True)

    dev_ms = _cuda_ms(torch, cascade, 10)
    k1, _ = _window_timings(torch, tk, wf_calls, labels, "dn_lut_apply")
    print(f"dn_lut_apply {noisy.shape}: x1 cascade on the card (CUDA "
          f"events) {dev_ms:.3f} ms, of which K1 {k1['ms']:.3f} (bound "
          f"{k1['bound_ms']:.3f}); dn_lut_apply host clock (table build, "
          f"H2D, D2H included) {host_ms:.3f} ms; PSNR noisy "
          f"{psnr(frame, noisy):.3f} dB, denoised {psnr(frame, den):.3f} "
          f"dB, gain {psnr(frame, den) - psnr(frame, noisy):.3f} dB (4-pixel "
          "border shaved)")
    if card:
        _profile(torch, cascade, dev_ms, top=10, what="x1 cascade")
    del tabs, x, wf_calls

    # 17.4 demosaic
    batches = _task_crops(rng, size["task_steps"], size["task_batch"],
                          size["task_crop"], rgb=True)
    rec, restore = _timed_steps(torch, tsk, "make_dm_train_step", dev)
    try:
        dm, losses = tsk.train_dm(iter(batches), nf=size["task_nf"],
                                  iters=size["task_steps"], device=dev)
    finally:
        restore()
    px = size["task_batch"] * size["task_crop"] ** 2 // 4
    _step_readings(torch, rec, "train_dm", 3 * 2 * px * _unit_macs(dm))
    lut = tsk.dm_transfer(dm, interval=INTERVAL, device=dev)
    if lut.shape != ((2 ** (8 - INTERVAL) + 1) ** 4, 12) or \
            lut.dtype != np.int8:
        raise RuntimeError(f"dm_transfer: {lut.shape} {lut.dtype}")
    mosaic = tsk.bayer_mosaic(frame)
    t0 = time.perf_counter()
    dmo = tsk.dm_lut_apply(lut, mosaic, interval=INTERVAL, device=dev)
    host_ms = (time.perf_counter() - t0) * 1e3
    want = tsk.dm_lut_apply(lut, mosaic, interval=INTERVAL, device="cpu")
    if dmo.shape != frame.shape or not np.array_equal(dmo, want):
        raise RuntimeError(f"dm_lut_apply {dmo.shape}: "
                           f"{int((dmo != want).sum())} bytes differ from "
                           "the CPU path")
    xb = torch.from_numpy(mosaic.astype(np.int32)).to(dev)
    planes = [xb[0::2, 0::2], xb[0::2, 1::2], xb[1::2, 0::2], xb[1::2, 1::2]]
    lut_t = torch.as_tensor(lut.astype(np.int32), device=dev)

    def retrieval():
        return sx.simplex_planes_int(lut_t, planes, interval=INTERVAL)

    ms = _cuda_ms(torch, retrieval, 10)
    if card:
        _profile(torch, retrieval, ms, top=6, what="demosaic retrieval")
    print(f"dm_lut_apply: {lut.shape} int8 table, mosaic {mosaic.shape} -> "
          f"{dmo.shape} byte-equal to the CPU path; the retrieval on the "
          f"card (CUDA events, torch ops) {ms:.3f} ms, dm_lut_apply host "
          f"clock {host_ms:.3f} ms; PSNR against the frame "
          f"{psnr(frame, dmo):.3f} dB")
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    return [
        {"name": "stage_ensemble_apply_w_students", "route": "cuda",
         "source": SOURCE_K3, "replaces": REPLACES_K3,
         "launches": k3_launches, "max_abs_err": k3_err, "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": "operations", "library_ms": None},
        {"name": "window_fold_contract_dn_x1", "route": "cuda",
         "source": SOURCE_K1W, "replaces": REPLACES_K1,
         "launches": k1_launches, "max_abs_err": wf_err, "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": "bytes", "library_ms": None}]


#: Phase 18 (`_cli`): the PNG tree (DIV2K of `div2k` images at `hr`^2, a
#: Set5 of `set5` HR sizes, structured images from seed 18), the runner's
#: config beyond the quick preset (`cfg`: none on the card, the reference
#: width), the train steps' batch (`batch` of `crop`^2 LR crops from the
#: tree) and units (`nets`: (arch, nf)), timed in `rounds` alternating
#: rounds of `steps` steps per precision, the isolated hanging step's
#: budget in seconds.
CLI = dict(div2k=8, hr=256, set5=((256, 256), (288, 352), (192, 320)),
           cfg={}, batch=32, crop=48, nets=(("dense", 64), ("mxu", 128)),
           steps=10, rounds=3, hang_budget=3)


def _png_tree(torch, base, size):
    """`base`/data as `run_evaluation(synthetic=False)` reads it, written
    by the port's PNG codec: DIV2K/HR, DIV2K/LR/X4 and SRBenchmark/Set5
    with HR and LR_bicubic/X4, each LR the port's bicubic downscale
    (`ops.resize.bicubic_resize_hw`, float32 on the host, rounded)."""
    from mulut_tpu_torch.data.synthetic import _synth_image
    from mulut_tpu_torch.ops.resize import bicubic_resize_hw
    from mulut_tpu_torch.utils.imgio import save_image

    def lr_of(hr):
        x = torch.from_numpy(np.ascontiguousarray(
            hr.transpose(2, 0, 1)).astype(np.float32))
        lr = bicubic_resize_hw(x, hr.shape[0] // SCALE, hr.shape[1] // SCALE)
        return np.clip(np.round(lr.numpy()), 0, 255).astype(
            np.uint8).transpose(1, 2, 0)

    rng = np.random.default_rng(18)
    data = os.path.join(base, "data")
    for i in range(1, size["div2k"] + 1):
        hr = _synth_image(rng, size["hr"])
        save_image(os.path.join(data, "DIV2K", "HR", f"{i:04d}.png"), hr)
        save_image(os.path.join(data, "DIV2K", "LR", f"X{SCALE}",
                                f"{i:04d}x{SCALE}.png"), lr_of(hr))
    set5 = os.path.join(data, "SRBenchmark", "Set5")
    for k, (h, w) in enumerate(size["set5"]):
        hr = _synth_image(rng, max(h, w))[:h, :w]
        save_image(os.path.join(set5, "HR", f"img{k}.png"), hr)
        save_image(os.path.join(set5, "LR_bicubic", f"X{SCALE}",
                                f"img{k}.png"), lr_of(hr))


def _same_files(a, b) -> list:
    """The files of directory `a`, each byte-equal to its namesake in
    `b` (raises otherwise)."""
    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)):
        raise RuntimeError(f"{a} and {b} hold other files")
    for f in names:
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            if fa.read() != fb.read():
                raise RuntimeError(f"{f}: bytes differ between {a} and {b}")
    return names


def _cli(torch, tk, *, dev="cuda", sizes=None):
    """Phase 18: the command line and the step runner on the card (module
    docstring); returns the kernels-line entries of the test step's K1 and
    K2.  `dev` and `sizes` (keys of CLI) exist for a rehearsal on the CPU
    at a small size; the card run takes the defaults."""
    import dataclasses
    import functools
    import tempfile

    from mulut_tpu_torch.data import DIV2K
    from mulut_tpu_torch.models.srnet import init_srnets
    from mulut_tpu_torch.models.torch_import import load_params_npz
    from mulut_tpu_torch.ops import unit_kernel as uk
    from mulut_tpu_torch.ops.resize import full_f32_matmul
    from mulut_tpu_torch.pipelines import orchestrator as orch
    from mulut_tpu_torch.pipelines.evaluate import LutEvaluator, run_test
    from mulut_tpu_torch.utils import profiling
    from mulut_tpu_torch.utils.imgio import load_image
    trm = importlib.import_module("mulut_tpu_torch.pipelines.train")

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    card = dev.type == "cuda"
    size = dict(CLI, **(sizes or {}))
    where = None if card else "cpu"     # the runner's device: None = card
    n_img = len(size["set5"])
    with tempfile.TemporaryDirectory() as base:
        _png_tree(torch, base, size)
        print(f"cli: PNG tree (port codec, no PIL): DIV2K {size['div2k']} x "
              f"{size['hr']}^2, Set5 {list(size['set5'])}, x{SCALE} LR by the "
              "port's bicubic downscale")

        # 18.2 the runner, its test step counted
        counts, dummies = [], []
        step_test = orch._step_test
        make_dummies = orch.Pipeline._create_dummy_luts

        def counted_test(cfg):
            _reset(tk.LAUNCHES, uk.LAUNCHES)
            out = step_test(cfg)
            counts.append((dict(tk.LAUNCHES), dict(uk.LAUNCHES)))
            return out

        def dummy(self, name):
            dummies.append(name)
            return make_dummies(self, name)

        orch._step_test, orch.Pipeline._create_dummy_luts = counted_test, dummy
        t0 = time.perf_counter()
        try:
            report = orch.run_evaluation("quick", base, synthetic=False,
                                         device=where, **size["cfg"])
        finally:
            orch._step_test = step_test
            orch.Pipeline._create_dummy_luts = make_dummies
        print(f"run_evaluation('quick') on {dev.type}: "
              f"{time.perf_counter() - t0:.1f} s; steps "
              + "; ".join(f"{k}: ok={v['ok']} verified={v['verified']} "
                          f"{v['seconds']} s" for k, v in
                          report["steps"].items()))
        bad = {k: v for k, v in report["steps"].items()
               if not (v["ok"] and v["verified"]) or v["error"]
               or v.get("timeout")}
        if bad or dummies or list(report["steps"]) != [
                "training", "transfer", "finetune", "test"]:
            raise RuntimeError(f"run_evaluation: steps {bad or report['steps']}"
                               f", dummy LUTs written {dummies}")
        launches, ulaunch = counts[0]
        want = {"gather_fold_contract": 0, "window_fold_contract": 6 * n_img,
                "tail_assemble": n_img}
        print(f"run_evaluation test step: {n_img} images, launches "
              f"{launches}, unit-kernel launches {ulaunch}")
        if card and (launches != want or any(ulaunch.values())):
            raise RuntimeError(f"test step launches {launches}, expected "
                               f"{want} and no unit kernel")
        summary = report["results"]
        cfg = orch.MuLutConfig(base_dir=base, mode="quick", device=where,
                               **size["cfg"])
        topt = orch._test_opt(cfg)
        topt.resultRoot = os.path.join(base, "results_cpu")
        t0 = time.perf_counter()
        cpu = run_test(topt, device="cpu")
        sub = os.path.join(os.path.basename(cfg.exp_dir), "Set5", f"X{SCALE}")
        files = _same_files(os.path.join(cfg.results_dir, sub),
                            os.path.join(topt.resultRoot, sub))
        if cpu != summary or len(files) != n_img:
            raise RuntimeError(f"summary {summary} on {dev.type}, {cpu} on "
                               f"the CPU path ({len(files)} files)")
        print(f"run_test on the CPU path ({time.perf_counter() - t0:.1f} s): "
              f"summary {cpu['Set5']} equal, {len(files)} result PNGs "
              "byte-equal")

        # 18.3 the step-4 script as a process
        line = "Dataset Set5 | AVG LUT PSNR: {:.2f} SSIM: {:.4f}".format(
            *summary["Set5"])
        script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "sr_torch", "4_test_lut.py")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, script, "-e", cfg.exp_dir, "--testDir",
             cfg.val_dir, "--resultRoot", os.path.join(base, "results_cli"),
             "--interval", str(cfg.interval)]
            + ([] if card else ["--device", "cpu"]),
            capture_output=True, text=True, timeout=600)
        got = res.stdout.splitlines()
        print(f"sr_torch/4_test_lut.py ({time.perf_counter() - t0:.1f} s, "
              f"exit {res.returncode}): {got}")
        if res.returncode != 0 or got != [line]:
            raise RuntimeError(f"4_test_lut.py printed {got}, expected "
                               f"[{line!r}]; stderr {res.stderr[-2000:]}")

        # 18.4 isolated steps: spawned processes
        iso = orch.Pipeline(dataclasses.replace(
            cfg, step_timeouts={"quick": 600}), isolate=True)
        got = {}
        t0 = time.perf_counter()
        iso._run_step("test", functools.partial(orch._step_test, cfg),
                      verify=lambda: True,
                      on_result=lambda r: got.setdefault("test", r))
        real_s = time.perf_counter() - t0
        hang = orch.Pipeline(dataclasses.replace(
            cfg, step_timeouts={"quick": size["hang_budget"]}), isolate=True)
        t0 = time.perf_counter()
        hang._run_step("hang", functools.partial(time.sleep, 600),
                       verify=lambda: False)
        hang_s = time.perf_counter() - t0
        step = hang.report["steps"]["hang"]
        print(f"isolate=True: test step in a spawned process {real_s:.1f} s, "
              f"summary {got.get('test')}; hanging step killed after "
              f"{hang_s:.1f} s (budget {size['hang_budget']} s): {step}")
        if (not iso.report["steps"]["test"]["ok"] or got.get("test") != summary
                or not step.get("timeout") or step["ok"]
                or hang_s > size["hang_budget"] + 30):
            raise RuntimeError(f"isolated steps: {iso.report['steps']}, "
                               f"{step}")

        # 18.5 the train step in float32 and in bf16
        im, lb = DIV2K(SCALE, cfg.train_dir, size["crop"], seed=0) \
            .sample_batch(size["batch"])
        kw = dict(modes=MODES, stages=STAGES, scale=SCALE)
        for arch, nf in size["nets"]:
            params = init_srnets(np.random.default_rng(0), nf=nf, arch=arch,
                                 **kw)
            # the two precisions alternate, `rounds` means of `steps`
            # steps each; the median round is reported
            batch = (torch.from_numpy(im).to(dev),
                     torch.from_numpy(lb).to(dev))
            runs = {}
            for prec in ("f32", "bf16"):
                p = trm.trainable(params, dev)
                runs[prec] = (p, trm.make_train_step(trm.make_optimizer(
                    trm.param_leaves(p), 1e-3, 1e-4, 100), precision=prec,
                    **kw))
            rounds = {"f32": [], "bf16": []}
            for _ in range(size["rounds"]):
                for prec, (p, step) in runs.items():
                    rounds[prec].append(_cuda_ms(
                        torch, lambda: step(p, *batch), size["steps"]))
            ms = {k: float(np.median(v)) for k, v in rounds.items()}
            del runs, batch
            io = {}
            for d in (dev, torch.device("cpu")):
                p = trm.trainable(params, d)
                leaves = [((u, n), p[u][n]) for u in sorted(p)
                          for n in sorted(p[u])]
                with full_f32_matmul():
                    io[d.type] = _loss_and_grads(torch, lambda: trm.train_loss(
                        p, torch.from_numpy(im).to(d),
                        torch.from_numpy(lb).to(d), precision="bf16", **kw),
                        leaves)
                del p, leaves
            _grad_gate(f"bf16 train step, {arch} nf={nf}, card vs CPU",
                       io[dev.type], io["cpu"], TRAIN_LOSS_REL,
                       TRAIN_GRAD_REL)
            print(f"train step {arch} nf={nf}, {size['batch']} x "
                  f"{size['crop']}^2: f32 {ms['f32']:.3f} ms, bf16 "
                  f"{ms['bf16']:.3f} ms per step (CUDA events, the median "
                  f"of {size['rounds']} alternating rounds of {size['steps']}"
                  f" steps: f32 " + " ".join(f"{x:.3f}" for x in
                                               rounds["f32"])
                  + ", bf16 " + " ".join(f"{x:.3f}" for x in rounds["bf16"])
                  + f"; bf16/f32 {ms['bf16'] / ms['f32']:.3f}); card: "
                  f"{_card() if card else 'the CPU (rehearsal)'}")
            del io

        # 18.6 resume the runner's own Opt_*.npz on the card
        k = cfg.total_iter
        ropt = orch._train_opt(cfg)
        ropt.startIter, ropt.totalIter = k, k + 2
        ropt.saveStep, ropt.valStep, ropt.displayStep = k + 2, 10 ** 9, 1
        rec, restore = _timed_steps(torch, trm, "make_train_step", dev)
        try:
            trm.train(ropt, device=dev)
        finally:
            restore()
        _step_readings(torch, rec, f"train(opt) resumed at {k}")
        with open(os.path.join(cfg.exp_dir, "train.log")) as f:
            resumed = f"Resumed params+optimizer from iter {k}" in f.read()
        saved = np.load(os.path.join(cfg.exp_dir, f"Opt_{k + 2:06d}.npz"))
        n_leaves = 2 * sum(len(u) for u in load_params_npz(
            os.path.join(cfg.exp_dir, f"Model_{k:06d}.npz")).values()) + 2
        counts_ = (int(saved["leaf_0"]), int(saved[f"leaf_{n_leaves - 1}"]))
        print(f"resume: Opt_{k:06d}.npz read ({resumed}); Opt_{k + 2:06d}.npz "
              f"{len(saved.files)} leaves (optax's layout {n_leaves}), "
              f"counts {counts_}")
        if not resumed or len(saved.files) != n_leaves or counts_ != (k + 2,
                                                                      k + 2):
            raise RuntimeError("resume from the runner's Opt_*.npz failed")

        # 18.7 the test step's K1 and K2 call sites on the first image
        ev = LutEvaluator.from_folder(cfg.exp_dir, stages=STAGES, modes=MODES,
                                      scale=SCALE, interval=cfg.interval,
                                      device=dev)
        lr = load_image(os.path.join(cfg.val_dir, "Set5", "LR_bicubic",
                                     f"X{SCALE}", "img0.png"))
        wf_calls, k2_calls = _record_calls(
            tk, ("window_fold_contract", "tail_assemble"),
            lambda: ev.upscale(lr))
        sites = [f"s{s + 1}_{m}" for s in range(STAGES) for m in MODES]
        wf_err, _, _ = _k1_checks(torch, tk, wf_calls, sites, "phase 18")
        k2_err = _k2_check(torch, tk, k2_calls[0], "phase 18")
        wf, _ = _window_timings(torch, tk, wf_calls, sites, "phase 18")
        k2 = _k2_timings(torch, tk, k2_calls[0], "phase 18")
        trace_dir = os.path.join(base, "trace")
        ev.upscale(lr)
        with profiling.trace(trace_dir):
            for _ in range(3):
                ev.upscale(lr)
        tl = profiling.device_timeline(trace_dir)
        if tl:
            print(f"phase 18 trace, 3 x upscale {lr.shape}: device span "
                  f"{tl['span_ms']:.3f} ms, busy {tl['busy_ms']:.3f}, idle "
                  f"{tl['idle_ms']:.3f} (idle share "
                  f"{tl['idle_ms'] / tl['span_ms']:.3f}); longest gaps "
                  + ", ".join(f"{g:.3f} ms after {a[:40]}"
                              for g, a, _ in tl["gaps"][:3]))
            for t, name, n in profiling.op_breakdown(trace_dir, top=6):
                print(f"  {t / 3:8.3f} ms per call  x{n // 3:<3d} {name[:90]}")
        else:
            print("phase 18 trace: no device events (not measured)")
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    return [
        {"name": "window_fold_contract_cli", "route": "cuda",
         "source": SOURCE_K1W, "replaces": REPLACES_K1,
         "launches": launches["window_fold_contract"], "max_abs_err": wf_err,
         "ms": wf["ms"], "plain_ms": wf["plain_ms"],
         "bound_ms": wf["bound_ms"], "bound_by": "bytes", "library_ms": None},
        {"name": "tail_assemble_cli", "route": "cuda", "source": SOURCE_K2,
         "replaces": REPLACES_K2, "launches": launches["tail_assemble"],
         "max_abs_err": k2_err, "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": "bytes",
         "library_ms": None}]


def _k3_gate(what, card, ulaunch, count):
    print(f"{what}: unit-kernel launches {ulaunch}")
    if card and ulaunch != _only(ulaunch, "stage_ensemble_apply_w", count):
        raise RuntimeError(f"{what}: expected {count} K3 launches only")


def _net_equal(torch, what, got, want):
    """Net-mode outputs byte for byte (uint8 after the evaluators' clip
    and round); on a difference, the first differing element."""
    g, w = got, want
    if g.dtype != torch.uint8:
        g = torch.round(torch.clamp(g.float(), 0, 255)).to(torch.uint8)
        w = torch.round(torch.clamp(w.float(), 0, 255)).to(torch.uint8)
    if g.shape != w.shape or not torch.equal(g, w):
        first = (torch.nonzero(g != w)[0].tolist() if g.shape == w.shape
                 else f"shapes {tuple(g.shape)} {tuple(w.shape)}")
        raise RuntimeError(f"{what}: differs from the unsharded card forward "
                           f"(first differing element {first})")
    print(f"{what}: {tuple(g.shape)} bytes equal to the unsharded forward")


def _phase_only(phase) -> int:
    """`--training`, `--nf256`, `--lut-rank`, `--parallel`, `--tasks` and
    `--cli`: the card, the kernel build (with ptxas's report for `--nf256`
    and `--lut-rank`) and phase 13, 14, 15, 16, 17 or 18 alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mulut_tpu_torch.ops import _build
    from mulut_tpu_torch.ops import tail_kernel as tk

    print(f"card: {_card()}")
    logs = _build.build_all()
    rng = np.random.default_rng(0)      # phase 3's draws: the same batch
    _random_luts(rng)
    imgs = rng.integers(0, 256, (BATCH, H, W, 3), dtype=np.int64).astype(
        np.uint8)
    if phase == "training":
        _training_half(torch, tk, imgs)
    elif phase == "parallel":
        _parallel(torch, tk, imgs)
    elif phase == "tasks":
        print(json.dumps({"kernels": _tasks(torch, tk, imgs)}))
    elif phase == "cli":
        print(json.dumps({"kernels": _cli(torch, tk)}))
    elif phase == "lut-rank":
        _ptxas_report({k: v for k, v in logs.items()
                       if k in ("window_fold", "fold_contract")})
        print(json.dumps({"kernels": _lut_rank(torch, tk, imgs)}))
    else:
        _ptxas_report({k: v for k, v in logs.items()
                       if k.startswith("plain_") and k != "plain_w8a8"})
        print(json.dumps({"kernels": _plain_nf256(torch, tk, imgs)}))
    print(f"card: {_card()}")
    return 0


if __name__ == "__main__":
    ab = {"--plain-ab": "plain", "--w8a8-ab": "w8a8"}
    if sys.argv[1:2] and sys.argv[1] in ab:
        sys.exit(_ab(ab[sys.argv[1]], sys.argv[2:]))
    if sys.argv[1:2] == ["--sass"]:
        sys.exit(_sass(sys.argv[2:]))
    if sys.argv[1:2] in (["--training"], ["--nf256"], ["--lut-rank"],
                         ["--parallel"], ["--tasks"], ["--cli"]):
        sys.exit(_phase_only(sys.argv[1][2:]))
    if sys.argv[1:2] == ["--ab-one"]:
        one = {"plain": _plain_ab_one, "w8a8": _w8a8_ab_one}[sys.argv[2]]
        sys.exit(one(sys.argv[3]))
    sys.exit(main())

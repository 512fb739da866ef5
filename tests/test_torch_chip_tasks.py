"""`chip_smoke.py` phase 17 (distillation and the non-SR tasks) rehearsed
on the CPU at a small size: seed-0 dense nf=8 teachers, nf=16 students on
256 taps per step, 3 steps per unit and 2 image-space steps of 2 crops of
16^2, net mode and the students' tables on 2 frames of 12 x 20, denoise
and demosaic at nf=8 for 2 steps of 2 crops of 16^2, deployed on a 24 x
32 frame, interval 6 (tables of 625 rows), with the CUDA-event timer and
the `torch.cuda` calls stubbed.  The card-vs-CPU and kernel-vs-plain
gates compare the CPU path with itself here, and no kernel launches; what
this holds is that the phase runs end to end, that each gate passes on
the kernels' plain versions, that the x1 cascade's K1 call sites are the
expected ones, and that it prints each reading the card run reports.
"""

import time

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mulut_tpu_torch.ops import tail_kernel as tk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_ms(torch_, fn, reps):
    """One call on the host clock (the card run repeats `reps` times)."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def test_phase17_rehearsal_on_cpu(capsys, monkeypatch):
    for name, value in (("BATCH", 2), ("H", 12), ("W", 20), ("INTERVAL", 6),
                        ("TASKS", dict(
                            cs.TASKS, teacher_nf=8, student_nf=16, taps=256,
                            distill_steps=3, cascade_steps=2,
                            cascade_batch=2, cascade_crop=16, task_nf=8,
                            task_batch=2, task_crop=16, task_steps=2,
                            frame=(24, 32), crop=(8, 12)))):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "_cuda_ms", _cpu_ms)
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    imgs = np.random.default_rng(0).integers(0, 256, (2, 12, 20, 3)).astype(
        np.uint8)
    entries = cs._tasks(torch, tk, imgs, dev="cpu")
    out = capsys.readouterr().out
    assert [e["name"] for e in entries] == [
        "stage_ensemble_apply_w_students", "window_fold_contract_dn_x1"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(set(e) == keys for e in entries)
    for line in (
            "distillation: teachers are seed-0 dense units",
            "distill s1_s: final batch mse",
            "distill s2_y: final batch mse",
            "distill_unit steps (final stage): 18 steps, loss per step",
            "distill_finetune_cascade: 2 steps",
            "students K3 s1 inner raw acc",
            "students K3 s2 final final",
            "students net 8x12 crop, card vs CPU path: 1.000000",
            "students K3 s2 final: image sites=1440",
            "students' tables LutEvaluator.upscale_batch (2, 12, 20, 3): "
            "launches",
            "students' tables: crop (2, 8, 12, 3) byte-equal",
            "train_dn (sigma 15): 2 steps",
            "dn_transfer: 6 tables (625, 1) int8, tie flips against the CPU "
            "path 0",
            "dn_lut_apply: window_fold_contract s1_s u=4 rot=1 (625, 64) int8 "
            "C=16",
            "dn_lut_apply: window_fold_contract s1_y u=1 rot=4 (625, 16) "
            "int32",
            "dn_lut_apply: window_fold_contract s2_d u=4 rot=1 (625, 64) int8 "
            "C=16",
            "dn_lut_apply (24, 32, 3): launches",
            "dn_lut_apply: crop (8, 12, 3) byte-equal to the CPU path",
            "dn_lut_apply (24, 32, 3): x1 cascade on the card",
            "train_dm: 2 steps",
            "dm_lut_apply: (625, 12) int8 table, mosaic (24, 32) -> (24, 32, "
            "3) byte-equal to the CPU path",
            "phase 17: "):
        assert line in out, line

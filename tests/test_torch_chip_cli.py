"""`chip_smoke.py` phase 18 (the command line and the step runner)
rehearsed on the CPU at a small size: the quick preset cut to nf=4,
interval 6 (tables of 625 rows), 2 train and 2 fine-tune steps of 2 crops
of 8^2, on a PNG tree of 4 training images of 32^2 and a Set5 of two
images; the f32 and bf16 train steps at dense and mxu nf=8 on 2 crops of
8^2, 2 alternating rounds of 2 timed steps; the CUDA-event timer, the card's name and
the `torch.cuda` calls stubbed.  The card-vs-CPU and kernel-vs-plain
gates compare the CPU path with itself here, and no kernel launches (the
counts read 0); what this holds is that the phase runs end to end (the runner, the
step-4 script as a process, the spawned isolated steps, the resume from
the runner's own optimizer file), that each gate passes on the kernels'
plain versions, that the test step's K1 and K2 call sites are the
expected ones, and that it prints each reading the card run reports.
"""

import time

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


def test_phase18_rehearsal_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(cs, "_cuda_ms", _cpu_ms)
    monkeypatch.setattr(cs, "_card", lambda: "no card")
    # the script and the spawned steps: torch on one thread too
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    sizes = dict(div2k=4, hr=32, set5=((32, 32), (40, 48)),
                 cfg=dict(nf=4, interval=6, train_iters={"quick": 2},
                          finetune_iters={"quick": 2},
                          batch_sizes={"quick": 2}, crop_sizes={"quick": 8}),
                 batch=2, crop=8, nets=(("dense", 8), ("mxu", 8)), steps=2,
                 rounds=2, hang_budget=2)
    entries = cs._cli(torch, tk, dev="cpu", sizes=sizes)
    out = capsys.readouterr().out
    assert [e["name"] for e in entries] == ["window_fold_contract_cli",
                                            "tail_assemble_cli"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(set(e) == keys for e in entries)
    assert [e["launches"] for e in entries] == [0, 0]
    assert [e["max_abs_err"] for e in entries] == [0, 0]
    for line in (
            "cli: PNG tree (port codec, no PIL): DIV2K 4 x 32^2",
            "run_evaluation('quick') on cpu: ",
            "training: ok=True verified=True",
            "test: ok=True verified=True",
            "run_evaluation test step: 2 images, launches "
            "{'gather_fold_contract': 0, 'window_fold_contract': 0, "
            "'tail_assemble': 0}",
            "result PNGs byte-equal",
            "sr_torch/4_test_lut.py (",
            "exit 0): ['Dataset Set5 | AVG LUT PSNR: ",
            "isolate=True: test step in a spawned process",
            "hanging step killed after",
            "bf16 train step, dense nf=8, card vs CPU: loss card",
            "bf16 train step, mxu nf=8, card vs CPU: loss card",
            "train step dense nf=8, 2 x 8^2: f32 ",
            "the median of 2 alternating rounds of 2 steps: f32 ",
            "train step mxu nf=8, 2 x 8^2: f32 ",
            "card: the CPU (rehearsal)",
            "train(opt) resumed at 2: 2 steps, loss per step",
            "resume: Opt_000002.npz read (True); Opt_000004.npz 146 leaves "
            "(optax's layout 146), counts (4, 4)",
            "phase 18: window_fold_contract s1_s, grid 3 x (9, 9)",
            "phase 18: window_fold_contract s2_y, grid 3 x (9, 128)",
            "phase 18: window_fold_contract s2_y sites=3456",
            "phase 18 tail_assemble: out",
            "phase 18 tail_assemble: ms=",
            "phase 18 trace: no device events (not measured)",
            "phase 18: "):
        assert line in out, line

"""The port's step runner (`pipelines/orchestrator.py`) against the JAX
package's on the CPU.

Both packages run the quick preset, cut to 2 training and 2 fine-tuning
steps of 2 crops of 8^2 at nf=4, mode "s" and interval 6 (tables of 625
rows; the JAX package's compiles set the pace), on
one synthetic tree of 4 training images and 2 benchmark images at 32 px
written once by the JAX package's generator (`runs`, shared by the
module).  What must match is behaviour, not numbers (the two packages'
inits draw from different generators): every step `ok` and `verified`,
the same report keys, the same step names and fields, the same artifact
names and LUT shapes, the same PSNR log lines scraped.  The budgets: a
hanging step dies at its budget in-process (SIGALRM) and with
`isolate=True` (a spawned process, killed), the report completing; full
mode raises where quick mode records.  An isolated real step (the test
step on the module's tables) returns the in-process summary, equal.
"""

import functools
import importlib
import json
import os
import time

import numpy as np
import pytest
import torch

from mulut_tpu.data.synthetic import create_synthetic_dataset

jorch = importlib.import_module("mulut_tpu.pipelines.orchestrator")
torch_orch = importlib.import_module("mulut_tpu_torch.pipelines.orchestrator")

CFG = dict(nf=4, interval=6, modes="s", train_iters={"quick": 2},
           finetune_iters={"quick": 2}, batch_sizes={"quick": 2},
           crop_sizes={"quick": 8}, step_timeouts={"quick": 1200})
STEPS = ["training", "transfer", "finetune", "test"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{package: (base dir, report)} of `run_evaluation("quick")`."""
    root = tmp_path_factory.mktemp("runner")
    out = {}
    for pkg, mod, kw in (("jax", jorch, {}),
                         ("torch", torch_orch, {"device": "cpu"})):
        base = str(root / pkg)
        create_synthetic_dataset(os.path.join(base, "data"), n_train=4,
                                 n_val=2, size=32, scales=(4,))
        out[pkg] = (base, mod.run_evaluation("quick", base, **CFG, **kw))
    return out


def test_every_step_ok_and_verified(runs):
    base, report = runs["torch"]
    assert list(report["steps"]) == STEPS
    for name in STEPS:
        step = report["steps"][name]
        assert step["ok"] and step["verified"] and step["error"] is None, (
            name, step)
        assert "timeout" not in step
    psnr, ssim = report["results"]["Set5"]
    assert np.isfinite(psnr) and np.isfinite(ssim)
    with open(os.path.join(base, "evaluation_quick.json")) as f:
        assert json.load(f)["steps"] == json.loads(json.dumps(
            report["steps"]))


def _artifacts(base):
    """Relative paths of everything the runner wrote (not the data tree,
    the TensorBoard event files' host/time suffix cut)."""
    out = set()
    for d, _, files in os.walk(base):
        rel = os.path.relpath(d, base)
        if rel.split(os.sep)[0] == "data":
            continue
        for f in files:
            if f.startswith("events.out.tfevents"):
                f = "events.out.tfevents"
            out.add(os.path.join(rel, f))
    return out


def test_report_and_artifacts_match_jax(runs):
    (jbase, jrep), (tbase, trep) = runs["jax"], runs["torch"]
    assert list(trep) == list(jrep)
    assert list(trep["steps"]) == list(jrep["steps"])
    for name in STEPS:
        assert list(trep["steps"][name]) == list(jrep["steps"][name])
        assert jrep["steps"][name]["ok"] and jrep["steps"][name]["verified"]
    assert list(trep["results"]) == list(jrep["results"])
    assert trep["analysis"]["luts"] == jrep["analysis"]["luts"]
    assert {k: sorted(v) for k, v in trep["analysis"]["psnr"].items()} == {
        k: sorted(v) for k, v in jrep["analysis"]["psnr"].items()}
    assert _artifacts(tbase) == _artifacts(jbase)


def _hang():
    time.sleep(60)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_budget_kills_hanging_step(tmp_path, pkg):
    mod = jorch if pkg == "jax" else torch_orch
    cfg = mod.MuLutConfig(base_dir=str(tmp_path), mode="quick",
                          step_timeouts={"quick": 1})
    pipe = mod.Pipeline(cfg)
    t0 = time.time()
    assert not pipe._run_step("hang", _hang, verify=lambda: False)
    assert time.time() - t0 < 10
    step = pipe.report["steps"]["hang"]
    assert step["timeout"] and not step["ok"]
    assert step["error"] == "step exceeded its 1s budget"
    assert list(step) == ["ok", "verified", "seconds", "budget", "error",
                          "timeout"]
    assert pipe._run_step("after", lambda: None, verify=lambda: True)


def test_isolated_steps_are_spawned_and_killed(tmp_path, runs, monkeypatch):
    """isolate=True: a hanging step (a picklable partial) is killed at its
    budget; a real step runs in its own process (torch on one thread, as
    this module) and hands back its result; a closure cannot be sent to a
    spawned process and fails as a step does."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = torch_orch.MuLutConfig(base_dir=str(tmp_path), mode="quick",
                                 step_timeouts={"quick": 2})
    pipe = torch_orch.Pipeline(cfg, isolate=True)
    t0 = time.time()
    assert not pipe._run_step("hang", functools.partial(time.sleep, 60),
                              verify=lambda: False)
    assert time.time() - t0 < 20
    step = pipe.report["steps"]["hang"]
    assert step["timeout"] and "subprocess killed" in step["error"]

    got = {}
    base, report = runs["torch"]
    run_cfg = torch_orch.MuLutConfig(base_dir=base, mode="quick",
                                     device="cpu", **CFG)
    pipe = torch_orch.Pipeline(run_cfg, isolate=True)
    assert pipe._run_step("test", functools.partial(torch_orch._step_test,
                                                    run_cfg),
                          verify=lambda: True,
                          on_result=lambda r: got.setdefault("test", r))
    assert got["test"] == report["results"]
    assert not pipe._run_step("closure", lambda: 1, verify=lambda: False)
    assert not pipe.report["steps"]["closure"]["ok"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_full_mode_raises_where_quick_records(tmp_path, pkg):
    mod = jorch if pkg == "jax" else torch_orch
    full = mod.Pipeline(mod.MuLutConfig(base_dir=str(tmp_path), mode="full",
                                        step_timeouts={"full": 1}))
    with pytest.raises(mod.StepTimeoutError):
        full._run_step("hang", _hang, verify=lambda: False)
    with pytest.raises(ZeroDivisionError):
        full._run_step("fail", lambda: 1 / 0, verify=lambda: False)
    quick = mod.Pipeline(mod.MuLutConfig(base_dir=str(tmp_path)))
    assert not quick._run_step("fail", lambda: 1 / 0, verify=lambda: False)
    assert quick.report["steps"]["fail"]["error"].startswith(
        "ZeroDivisionError")


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_lenient_fallback_writes_dummy_luts(tmp_path, pkg):
    """A failed transfer in quick mode leaves the dummy tables later steps
    read (ref: sr/main.py:935-956): the same files and bytes."""
    mod = jorch if pkg == "jax" else torch_orch
    cfg = mod.MuLutConfig(base_dir=str(tmp_path), interval=6)
    pipe = mod.Pipeline(cfg)
    assert not pipe._run_step("transfer", lambda: 1 / 0,
                              pipe._verify_lut_output,
                              fallback=lambda: pipe._create_dummy_luts("LUT"))
    step = pipe.report["steps"]["transfer"]
    assert not step["ok"] and step["verified"]
    names = sorted(os.listdir(cfg.exp_dir))
    assert names == [f"LUT_x4_6bit_int8_s{s}_{m}.npy" for s in (1, 2)
                     for m in "dsy"]
    arr = np.load(os.path.join(cfg.exp_dir, names[-1]))
    assert arr.shape == (625, 16) and arr.dtype == np.int8

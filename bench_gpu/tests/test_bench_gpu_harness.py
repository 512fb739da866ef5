"""A run of each cell on the CPU at a tiny size through the test hooks
(`run.py` itself refuses without a card), the faults and the controls
that `correct` has to catch, and the check that no run loads JAX or the
JAX package."""

import json
import subprocess
import sys

import pytest
import torch

from bench_gpu import calibrate, harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = tuple(w["name"] for w in SPEC["workloads"])
SEED = 2**31 + 17


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal(cell, traced, tiny):
    r = harness.run_cell(cell, seed=SEED, seconds=0.3, traced=traced,
                         device="cpu", overrides=tiny, log=lambda m: None)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "check" and r["check"]
    assert {"kernels_built", "init_s", "warmup_s"} <= set(r["setup"])
    spec = harness.cell_spec(cell)
    want = spec["per_layer"] if traced else spec["end_to_end"]
    if traced:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "init_s" in r["metrics"]
    else:
        assert set(r["metrics"]) == {m["name"] for m in want}
    assert set(r["metrics"]) <= {m["name"] for m in want}
    for m in r["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]
    json.dumps(r)


class Broken:
    """The entry's runner with the timed path broken underneath."""

    def __init__(self, drv, fault):
        self.drv, self.fault, self.prev = drv, fault, None

    def __getattr__(self, k):
        return getattr(self.drv, k)

    def run(self, x):
        out = self.drv.run(x)
        if self.fault == "unchanged":       # hands back the last answer
            prev, self.prev = self.prev, out
            if prev is None:
                prev = out * 0
            return prev
        out = out.clone() if torch.is_tensor(out) else out.copy()
        if self.fault == "half":            # half of the batch left out
            out[out.shape[0] // 2:] = 0
        else:                               # one frame's answer altered
            out[0] += 16
        return out


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_come_out_incorrect(cell, fault, tiny):
    entry = harness.load_module("entries",
                                harness.cell_spec(cell)["cell"]["entry"])

    def build(*a):
        return Broken(entry.build(*a), fault)

    r = harness.run_cell(cell, seed=SEED, seconds=0.3, traced=False,
                         device="cpu", overrides=tiny, build=build,
                         log=lambda m: None)
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_incorrect(cell, tiny):
    recs = list(calibrate.readings_over_seeds(
        cell, [SEED], variant="control", seconds=0.3, device="cpu",
        overrides=tiny))
    assert not recs[0]["correct"]


def test_run_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "bench_gpu/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""


def test_forbidden_names_are_whole_top_level_names():
    sys.path.insert(0, str(harness.BENCH))
    try:
        import run
    finally:
        sys.path.pop(0)
    saved = dict(sys.modules)
    try:
        for m in [m for m in sys.modules
                  if m.split(".")[0] in run.FORBIDDEN]:
            del sys.modules[m]
        sys.modules["mulut_tpu_torch_x"] = object()
        assert run.loaded_forbidden() == []
        sys.modules["mulut_tpu.ops"] = object()
        assert run.loaded_forbidden() == ["mulut_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


_PROBE = """
import sys, torch
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
{body}
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_modules(body: str) -> set:
    code = _PROBE.format(root=str(harness.ROOT), body=body)
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(p.stdout.split())


def test_a_run_loads_no_jax():
    body = f"""
from bench_gpu import harness
import bench_gpu.run
tiny = {{"traffic": {{"height": 12, "width": 20, "pool": 4,
                     "frames_per_batch": 2}},
        "cell": {{"warmup_batches": 1, "trace_batches": 2,
                 "check_batches": 2}}}}
for cell in {CELLS!r}:
    for traced in (False, True):
        harness.run_cell(cell, seed=5, seconds=0.2, traced=traced,
                         device="cpu", overrides=tiny, log=lambda m: None)
"""
    mods = _top_level_modules(body)
    assert "mulut_tpu_torch" in mods and "bench_gpu" in mods
    assert not mods & {"jax", "jaxlib", "flax", "mulut_tpu"}


def test_reference_loads_nothing_of_the_program():
    body = f"""
import numpy as np, torch
from bench_gpu import check, harness
frames = np.random.default_rng(0).integers(0, 256, (1, 6, 8, 3), np.uint8)
for cell in {CELLS!r}:
    cfg = harness.cell_spec(cell)["config"]
    kind = check.reference_kind(cfg)
    ref = kind.Reference(cfg, 5, harness.ROOT, "cpu")
    ref.outputs(frames)
    ctl = kind.Control(cfg, None, torch.device("cpu"), None, harness.ROOT,
                       5)
    ctl.result(ctl.run(ctl.inputs([frames])[0]))
"""
    mods = _top_level_modules(body)
    assert not mods & {"jax", "jaxlib", "flax", "mulut_tpu",
                       "mulut_tpu_torch"}

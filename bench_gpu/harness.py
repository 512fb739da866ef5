"""One run of one cell: set-up, warm-up, the measured (or traced) window,
the check against the reference, and the result's JSON object.

A cell is found by name: its `BENCHMARK.json` entry names the
configuration (`configs/<config>.json`, whose `kind` names its work
arithmetic `work/<kind>.py` and its reference `reference/<kind>.py`) and
the traffic (`traffic/<traffic>.json`); `workloads/<cell>.json` names the
entry (`entries/<entry>.py`), the warm-up and traced batch counts, the
sample that the check compares and each number's limit; each per-layer
metric is read by `metrics/<metric>.py`.  `run.py` calls `run_cell` on
the card; tests call it on the CPU at a tiny size, which `run.py` never
does.

Set-up runs in phases, each logged: `context` (the CUDA context),
`kernels` (the port's kernel libraries: built where
`mulut_tpu_torch/ops/_build/` lacks them, which happens in the first run
of a checkout, else found there), `init` (the program's construction,
`init_s`), `inputs` (the units where the seed draws them, the frame
pool), `warmup`.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import check, tracing, traffic as traffic_gen, work

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """`bench_gpu/<kind>/<name>.py` as a module (a metric's name may hold
    a dot, so the file is loaded by path)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_gpu.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reported(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_of_cell


def cell_spec(name: str, root: Path = ROOT) -> dict:
    """Everything one cell needs, from its name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    return {
        "name": name, "chips": w["chips"],
        "config": load_json(root / cfg_file),
        "traffic": load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        "cell": load_json(BENCH / "workloads" / f"{name}.json"),
        "end_to_end": e2e,
        "per_layer": [m for m in bench["per_layer"]
                      if _reported(m, name, e2e_names)],
    }


def _load_kernels(device) -> int | None:
    """Build what the port's kernel libraries lack (all of them in a
    checkout's first run); the count of sources built, None off the
    card."""
    if device.type != "cuda":
        return None
    from mulut_tpu_torch.ops import _build

    return len(_build.build_all())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _percentile(values: list, p: float) -> float:
    return float(np.percentile(np.asarray(values), p))


def _timed_window(drv, inputs, seconds, sample):
    """Closed loop, one client: batches in turn until `seconds` have
    passed; every batch's latency on the host clock."""
    lat = []
    t_begin = t1 = time.perf_counter()
    i = 0
    while t1 - t_begin < seconds:
        b = i % len(inputs)
        t0 = time.perf_counter()
        out = drv.run(inputs[b])
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        sample.offer(i, (b, out))
        i += 1
    return lat, t1 - t_begin


def _traced_window(drv, inputs, n, sample, span):
    """`n` batches under the profiler (CPU and CUDA activity); returns the
    Chrome trace's complete events."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for i in range(n):
            with span("batch"):
                out = drv.run(inputs[i % len(inputs)])
            sample.offer(i, (i % len(inputs), out))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return tracing.load_events(path)


def run_cell(name: str, *, seed: int, seconds: float, traced: bool,
             device="cuda", t_process: float | None = None,
             overrides: dict | None = None, build=None, log=print,
             root: Path = ROOT) -> dict:
    """One run of cell `name`; returns the result object.

    `t_process`: perf_counter() value of the process's start (set-up is
    counted from it).  Hooks, which `run.py` never passes: `overrides`
    replaces keys of the traffic and workload files ({"traffic": {...},
    "cell": {...}}); `build` replaces the entry's `build` (a control or a
    broken program in the program's place, `calibrate.py` and tests)."""
    t_process = time.perf_counter() if t_process is None else t_process
    spec = cell_spec(name, root)
    for part, upd in (overrides or {}).items():
        spec[part] = {**spec[part], **upd}
    cfg, traf, cell = spec["config"], spec["traffic"], spec["cell"]
    device = torch.device(device)
    phases = {}

    t = time.perf_counter()
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)
    phases["context"] = time.perf_counter() - t

    t = time.perf_counter()
    built = _load_kernels(device)
    phases["kernels"] = time.perf_counter() - t
    if built is not None:
        log(f"kernel libraries: {built} source(s) built" if built else
            "kernel libraries: every one found in mulut_tpu_torch/ops/_build/")

    span = tracing.span_factory(traced)
    entry = load_module("entries", cell["entry"])
    t = time.perf_counter()
    drv = (build or entry.build)(cfg, traf, device, span, root, seed)
    phases["init"] = drv.init_s
    phases["inputs"] = time.perf_counter() - t - drv.init_s

    t = time.perf_counter()
    pool = traffic_gen.frame_pool(seed, traf)
    frame_batches = traffic_gen.batches(pool, traf["frames_per_batch"])
    inputs = drv.inputs(frame_batches)
    phases["inputs"] += time.perf_counter() - t

    t = time.perf_counter()
    for i in range(cell["warmup_batches"]):
        drv.run(inputs[i % len(inputs)])
    _sync(device)
    phases["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_process
    log("setup phases (s): " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in phases.items()))

    sample = check.Reservoir(cell["check_batches"], seed)
    wk = work.cell_work(cfg, traf)
    result_metrics, extra = {}, {}
    if traced:
        n = cell["trace_batches"]
        events = _traced_window(drv, inputs, n, sample, span)
        ctx = tracing.TraceContext(
            events, n_batches=n, work=wk, init_s=drv.init_s,
            port_kernels=tracing.port_kernels(root))
        for m in spec["per_layer"]:
            v = load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                result_metrics[m["name"]] = {"value": float(v),
                                             "unit": m["unit"]}
        attempted = n
        extra = {"busy_s": ctx.busy_s, "window_s": ctx.window_s}
        breakdown = ctx.breakdown()
        log(f"traced {n} batches over {ctx.window_s:.6f} s, device busy "
            f"{ctx.busy_s:.6f} s")
    else:
        lat, window_s = _timed_window(drv, inputs, seconds, sample)
        attempted = len(lat)
        e2e = {
            "out_mpix_s": attempted * work.out_pixels(cfg, traf) / 1e6
            / window_s,
            "batch_ms_p95": 1e3 * _percentile(lat, 95),
            "setup_s": setup_s,
        }
        for m in spec["end_to_end"]:
            result_metrics[m["name"]] = {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
        breakdown = None
        log(f"window {window_s:.6f} s, {attempted} batches, batch ms "
            f"median {1e3 * statistics.median(lat):.4f}")

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    got = [(b, drv.result(out)) for b, out in sample.items]
    state = drv.state()
    state = ({k: np.asarray(v) for k, v in state.items()}
             if state is not None else None)
    drv.close()
    del drv, inputs, sample
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    values, per_batch = check.readings(cfg, seed, frame_batches, got,
                                       state, root, device)
    correct, failed, numbers = check.judge(values, cell["limits"],
                                           per_batch)
    log(f"check: {len(got)} batches against the reference in "
        f"{time.perf_counter() - t:.3f} s; readings {values}")

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": spec["chips"], "memory_peak_bytes": int(peak), **extra}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": result_metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup"] = {"kernels_built": built,
                       **{f"{k}_s": v for k, v in phases.items()}}
    result["check"] = numbers
    return result

"""Profiling/tracing helpers.

The reference's observability is wall-clock dT/rT accumulators in the train
loops (ref: sr/1_train_model.py:183-201) — those are preserved in the
pipelines for log parity.  This module is the torch twin of
`mulut_tpu.utils.profiling`, the same surface on `torch.profiler`:

  * `trace` records a block (host ops, and the card's kernels where there
    is a card) and writes it as Chrome-trace JSON, viewable in Perfetto;
  * `annotate` names a region inside it;
  * `op_breakdown` and `device_timeline` read such a file: device time by
    kernel name, and the device's busy and idle time with its longest gaps;
  * `device_rows` reads a live profile (`torch.profiler.profile`) the
    same way, by kernel and by the torch op that launched it;
  * `device_time` times a call with CUDA events on the card and the host
    clock on the CPU.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time

#: Chrome-trace event categories of work on the card (Kineto's names)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record a `torch.profiler` trace around a block and write it to
    `log_dir` as `trace_<pid>_<ns>.json` (Chrome-trace JSON).

    Enabled when `log_dir` is given or MULUT_TRACE_DIR is set; otherwise a
    no-op, so call sites can wrap hot loops unconditionally.  Yields the
    live profile (None when disabled).  Records the card's kernels when
    torch sees a CUDA device, else host ops only.
    """
    log_dir = log_dir or os.environ.get("MULUT_TRACE_DIR")
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region inside a trace (`with annotate("stage2"): ...`)."""
    from torch.profiler import record_function

    return record_function(name)


def _device_events(trace_dir: str) -> list:
    """(start_us, end_us, name) of every device event in the newest trace
    file under `trace_dir` (`*.json` or `*.json.gz`, searched
    recursively); [] when there is none."""
    files = [f for pat in ("*.json", "*.json.gz") for f in glob.glob(
        os.path.join(trace_dir, "**", pat), recursive=True)]
    if not files:
        return []
    newest = max(files, key=os.path.getmtime)
    opener = gzip.open if newest.endswith(".gz") else open
    with opener(newest, "rt") as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return [(e["ts"], e["ts"] + e["dur"], e.get("name", "?"))
            for e in events
            if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in DEVICE_CATEGORIES]


def op_breakdown(trace_dir: str, top: int = 20) -> list:
    """Aggregate per-kernel device time from a `trace()` file.

    Returns [(total_ms, kernel_name, launches)] sorted by time, summed
    over all executions in the trace (divide by your run count); [] for a
    trace without device events (a CPU-only run).
    """
    agg: dict = {}
    for s, t, name in _device_events(trace_dir):
        entry = agg.setdefault(name, [0.0, 0])
        entry[0] += (t - s) / 1e3
        entry[1] += 1
    rows = sorted(((ms, name, n) for name, (ms, n) in agg.items()),
                  reverse=True)
    return rows[:top]


def device_timeline(trace_dir: str, top_gaps: int = 12) -> dict:
    """Device busy/idle analysis of a `trace()` file.

    Complements `op_breakdown` (which sums kernel durations): aggregates
    the device timeline itself to answer "where does wall time go that no
    kernel accounts for" — launch serialization, host sync stalls,
    inter-kernel bubbles.

    Returns {"span_ms", "busy_ms", "idle_ms", "gaps": [(gap_ms,
    after_kernel, before_kernel), ...]} where gaps are the largest idle
    holes between consecutive device events (merged across overlapping
    streams); {} for a trace without device events.
    """
    ivs = sorted(_device_events(trace_dir))
    if not ivs:
        return {}
    span = ivs[-1][1] - ivs[0][0]
    busy = 0.0
    gaps = []
    cur_s, cur_e, cur_n = ivs[0]
    for s, t, name in ivs[1:]:
        if s <= cur_e:  # overlap (parallel streams) — merge
            if t > cur_e:
                cur_e, cur_n = t, name
            continue
        busy += cur_e - cur_s
        gaps.append((s - cur_e, cur_n, name))
        cur_s, cur_e, cur_n = s, t, name
    busy += cur_e - cur_s
    gaps.sort(reverse=True)
    return {
        "span_ms": span / 1e3,
        "busy_ms": busy / 1e3,
        "idle_ms": (span - busy) / 1e3,
        "gaps": [(g / 1e3, a, b) for g, a, b in gaps[:top_gaps]],
    }


def device_rows(prof, runs: int = 1) -> tuple:
    """Device self time of a finished `torch.profiler.profile` per run:
    (kernels, ops), each a list of (ms, calls, name) — the kernels
    themselves, and the host-side torch ops that launched them (the same
    time, counted once each).  Ranges over other kernels (user
    annotations, an optimizer's step) are left out."""
    kernels, ops = [], []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if (t <= 0 or getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            continue
        row = (t / runs / 1e3, e.count // runs, e.key)
        on_device = "CUDA" in str(getattr(e, "device_type", ""))
        (kernels if on_device else ops).append(row)
    return kernels, ops


def _first_tensor(out):
    """The first tensor in a (nested) call result, or None."""
    import torch

    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


def device_time(fn, *args, n: int = 4, reps: int = 2) -> float:
    """Marginal seconds per `fn(*args)` execution.

    Runs n and then 2n executions and returns (t_2n - t_n) / n, which
    cancels a fixed launch and sync overhead; the marginal repeats `reps`
    times and the minimum wins (a stall can only inflate a marginal).
    When the call returns a tensor on a CUDA device, each group is timed
    with CUDA events on the current stream; otherwise on the host clock.
    """
    import torch

    out = _first_tensor(fn(*args))
    card = out is not None and out.is_cuda

    def wall(k):
        if card:
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            ev[0].record()
            for _ in range(k):
                fn(*args)
            ev[1].record()
            ev[1].synchronize()
            return ev[0].elapsed_time(ev[1]) / 1e3
        t0 = time.perf_counter()
        for _ in range(k):
            fn(*args)
        return time.perf_counter() - t0

    best = min((wall(2 * n) - wall(n)) / n for _ in range(reps))
    return max(best, 1e-9)

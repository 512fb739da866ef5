"""The traced run: the benchmark's own spans, the profiler's device
events, and the arithmetic that the per-layer readers share.

The idle-share and by-kernel arithmetic is a copy of
`mulut_tpu_torch.utils.profiling.device_timeline` and `op_breakdown`
(device events of Kineto's categories, streams merged), kept here so that
the yardstick does not move with the program.
"""

from __future__ import annotations

import contextlib
import json
import re
from pathlib import Path

#: Chrome-trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: the benchmark's span around one batch; the window runs from the first
#: one's start to the last one's end
BATCH_SPAN = "bench.batch"


def span_factory(enabled: bool):
    """`span(name)`: a profiler range named `bench.<name>` when tracing,
    else a no-op, so untraced runs pay nothing for it."""
    if not enabled:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function

    return lambda name: record_function(f"bench.{name}")


#: a kernel's name in a CUDA source: the identifier that opens the
#: parameter list after `__global__` (past any `__launch_bounds__(...)`)
_GLOBAL = re.compile(r"__global__([^{;]*)")
_CALLED = re.compile(r"([A-Za-z_]\w*)\s*\(")


def port_kernels(root: Path) -> tuple:
    """Names of the program's own kernels: every `__global__` function of
    the CUDA sources in `mulut_tpu_torch/ops/csrc/`, read from the
    checkout, so that a kernel a later change adds counts as the
    program's and not as glue."""
    names = set()
    for path in sorted((Path(root) / "mulut_tpu_torch" / "ops" / "csrc")
                       .glob("*.cu*")):
        for head in _GLOBAL.findall(path.read_text()):
            called = [n for n in _CALLED.findall(head)
                      if n != "__launch_bounds__"]
            if called:
                names.add(called[-1])
    return tuple(sorted(names))


def load_events(path: str) -> list:
    """The complete ("X") events of a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _merge(ivs: list) -> list:
    """Sorted (start, end, last name) intervals with overlaps merged."""
    merged = []
    for s, t, name in sorted(ivs):
        if merged and s <= merged[-1][1]:
            if t > merged[-1][1]:
                merged[-1] = (merged[-1][0], t, name)
            continue
        merged.append((s, t, name))
    return merged


def short_name(name: str, width: int = 80) -> str:
    """A kernel's name without its return type and arguments."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)",
                                                 "(anon)")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and not name.startswith("(anon)", i):
            cut = i
            break
    return name[:cut].strip()[:width]


class TraceContext:
    """What the readers in `metrics/` read: the device events inside the
    window (`device`: (start us, end us, name, category)), the benchmark's
    spans, the batch count, the work of a batch (`work.cell_work`), the
    names of the program's own kernels (`port_kernels`) and the host
    clock's readings (`init_s`)."""

    def __init__(self, events: list, *, n_batches: int, work: dict,
                 port_kernels: tuple, init_s: float):
        spans = [e for e in events if e.get("name", "").startswith("bench.")
                 and e.get("cat") == "user_annotation"]
        batches = [e for e in spans if e["name"] == BATCH_SPAN]
        if not batches:
            raise ValueError("the trace holds no batch span")
        self.t0 = min(e["ts"] for e in batches)
        self.t1 = max(e["ts"] + e["dur"] for e in batches)
        self.spans = spans
        self.device = [(max(e["ts"], self.t0),
                        min(e["ts"] + e["dur"], self.t1), e["name"],
                        e.get("cat"))
                       for e in events if e.get("cat") in DEVICE_CATEGORIES
                       and e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.n_batches = n_batches
        self.work = work
        self.port_kernels = tuple(port_kernels)
        self.init_s = init_s
        self.window_s = (self.t1 - self.t0) / 1e6
        self.batch_s = self.window_s / n_batches
        self.merged = _merge([(s, t, n) for s, t, n, _ in self.device])
        self.busy_s = sum(t - s for s, t, _ in self.merged) / 1e6

    @staticmethod
    def _matches(name: str, kernels) -> bool:
        return any(re.search(rf"(?<![A-Za-z0-9_]){k}(?![A-Za-z0-9_])", name)
                   for k in kernels)

    def kernel_s(self, kernels) -> float:
        """Device seconds per batch of the kernels named in `kernels`."""
        return sum(t - s for s, t, n, c in self.device
                   if c == "kernel" and self._matches(n, kernels)
                   ) / 1e6 / self.n_batches

    def glue_s(self) -> float:
        """Device seconds per batch of every kernel that is not one of the
        program's own (torch's ops between them)."""
        return sum(t - s for s, t, n, c in self.device
                   if c == "kernel" and not self._matches(n, self.port_kernels)
                   ) / 1e6 / self.n_batches

    def roofline_pct(self, bound_key: str, kernels):
        """The work's bound over the kernels' device time per batch, in %;
        None where none of them ran."""
        t = self.kernel_s(kernels)
        return 100.0 * self.work[bound_key] / t if t > 0 else None

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps labelled by the innermost benchmark span open on the host
        (or "harness"), each in seconds over the window."""
        agg: dict = {}
        for s, t, n, _ in self.device:
            k = short_name(n)
            agg[k] = agg.get(k, 0.0) + (t - s) / 1e6
        ops = sorted(agg.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        edges = [(self.t0, self.t0, "window start")] + self.merged + [
            (self.t1, self.t1, "window end")]
        for (_, e0, before), (s1, _, _) in zip(edges, edges[1:]):
            if s1 > e0:
                gaps.append((s1 - e0, e0, before))
        gaps.sort(key=lambda g: -g[0])
        idle = []
        for dur, start, before in gaps[:top]:
            mid = start + dur / 2
            open_ = [e for e in self.spans
                     if e["ts"] <= mid <= e["ts"] + e["dur"]]
            host = (min(open_, key=lambda e: e["dur"])["name"] if open_
                    else "harness")
            idle.append([f"{host} after {short_name(before, 48)}",
                         dur / 1e6])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}

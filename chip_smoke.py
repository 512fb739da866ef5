#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and hold its
kernels against their plain versions.

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; exits non-zero without them.  Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from `mulut_tpu_torch/ops/csrc/`;
  3. `LutEvaluator` construction: x4, 2 stages, modes sdy, interval 4
     (17**4-row int8 LUTs, random from seed 0), tables built on the card;
  4. a recording run of the cascade on the batch, which keeps every kernel
     call's inputs; each kernel is then compared byte for byte with its
     plain torch version on those inputs;
  5. `LutEvaluator.upscale_batch` on 8 x 270 x 480 x 3 uint8 frames (the
     repo's bench shape) with every launch counter set to 0 just before and
     read just after; one frame is checked byte-equal against the port's
     CPU path;
  6. timings with CUDA events: batch ms and output MPix/s, and per kernel
     call site its time, its bound, its plain version's time and, for the
     contraction, one `torch.einsum` over the gathered rows (a yardstick,
     never called by the port).

Prints a `{"kernels": [...]}` line and ends with one
`{"ok": true, "device": {...}}` line.  Any failed phase raises.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

STAGES, MODES, SCALE, INTERVAL = 2, "sdy", 4, 4
BATCH, H, W = 8, 270, 480
HBM_BYTES_PER_MS = 3.35e9          # H100 SXM: 3.35 TB/s
SOURCE_K1 = "mulut_tpu_torch/ops/csrc/fold_contract.cu"
SOURCE_K2 = "mulut_tpu_torch/ops/csrc/tail_assemble.cu"
REPLACES_K1 = "mulut_tpu/ops/tail_kernel.py:181"
REPLACES_K2 = "mulut_tpu/ops/tail_kernel.py:546"


def _random_luts(rng):
    """Seed-0 random int8 LUTs of the shipped shapes (as bench.py makes them
    when the reference LUTs are absent)."""
    L = 2 ** (8 - INTERVAL) + 1
    luts = {}
    for s in range(STAGES):
        v = SCALE * SCALE if s + 1 == STAGES else 1
        for m in MODES:
            luts[f"s{s + 1}_{m}"] = rng.integers(
                -127, 128, (L ** 4, v), dtype=np.int64).astype(np.int8)
    return luts


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


def _record_calls(tk, run):
    """Run `run()` with the two kernel wrappers wrapped so that every call's
    arguments are kept; returns (k1_calls, k2_calls)."""
    k1, k2 = [], []
    orig_k1, orig_k2 = tk.gather_fold_contract, tk.tail_assemble

    def rec_k1(tab, base, wt, *, C, u):
        k1.append((tab, base, wt, C, u))
        return orig_k1(tab, base, wt, C=C, u=u)

    def rec_k2(folded, quads, **kw):
        k2.append((folded, quads, kw))
        return orig_k2(folded, quads, **kw)

    tk.gather_fold_contract, tk.tail_assemble = rec_k1, rec_k2
    try:
        run()
    finally:
        tk.gather_fold_contract, tk.tail_assemble = orig_k1, orig_k2
    return k1, k2


def _profile(torch, cascade, dev_ms: float, runs: int = 3, top: int = 15):
    """Where the cascade's device time goes: torch.profiler over `runs`
    cascades, device time per op (self time, summed over the runs)."""
    from torch.profiler import ProfilerActivity, profile

    cascade()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            cascade()
        torch.cuda.synchronize()
    kernels, ops = [], []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t <= 0:
            continue
        row = (t / runs / 1e3, e.count // runs, e.key)
        # device-side rows are the kernels themselves; host-side rows are
        # the torch ops that launched them (same time, counted once each)
        on_device = "CUDA" in str(getattr(e, "device_type", ""))
        (kernels if on_device else ops).append(row)
    if not kernels:
        print("profile: the profiler recorded no device time (not measured)")
        return
    busy = sum(r[0] for r in kernels)
    print(f"profile: device busy {busy:.3f} ms of {dev_ms:.3f} ms per "
          f"cascade (idle share {max(0.0, 1 - busy / dev_ms):.3f})")
    for title, rows in (("kernels", kernels), ("torch ops", ops)):
        print(f"profile, top {title} by device time per cascade:")
        for ms, n, name in sorted(rows, reverse=True)[:top]:
            print(f"  {ms:8.3f} ms  x{n:<4d} {name[:100]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mulut_tpu_torch.ops import _build
    from mulut_tpu_torch.ops import tail_kernel as tk
    from mulut_tpu_torch.pipelines.evaluate import LutEvaluator

    dev = torch.device("cuda")
    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. kernel build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({len(logs)} sources compiled)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

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
    k1_calls, k2_calls = _record_calls(tk, cascade)
    sites = ["s1_s", "s1_d", "s2_s", "s2_d"] + [f"s2_y r{r}" for r in range(4)]
    if len(k1_calls) != len(sites) or len(k2_calls) != 1:
        raise RuntimeError(f"recorded {len(k1_calls)} contraction and "
                           f"{len(k2_calls)} tail calls; expected 8 and 1")
    k1_err = 0.0
    for site, (tab, base, wt, C, u) in zip(sites, k1_calls):
        got = tk.gather_fold_contract(tab, base, wt, C=C, u=u)
        want = tk.gather_fold_contract_plain(tab, base, wt, C=C, u=u)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        k1_err = max(k1_err, err)
        if not torch.equal(got, want):
            raise RuntimeError(f"gather_fold_contract differs at {site}: "
                               f"max abs err {err}")
        print(f"K1 {site}: (C={C}, u={u}, Np={base.shape[0]}) "
              f"byte-equal to plain")
    folded, quads, kw = k2_calls[0]
    got = tk.tail_assemble(folded, quads, **kw)
    bc = int(np.prod(kw["lead"]))
    wp = tk._pad128(kw["w"])
    want = tk.tail_assemble_plain(folded, quads, bc=bc, h=kw["h"], wp=wp,
                                  scale=kw["scale"], davg=kw["davg"])
    torch.cuda.synchronize()
    k2_err = (got.view(torch.uint8).int()
              - want.view(torch.uint8).int()).abs().max().item()
    if not torch.equal(got, want):
        raise RuntimeError(f"tail_assemble differs: max abs err {k2_err}")
    print(f"K2 tail_assemble: out {tuple(got.shape)} byte-equal to plain")

    # 5. the main path through the entry point, counted
    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    out = ev.upscale_batch(imgs)
    first_s = time.perf_counter() - t0
    launches = dict(tk.LAUNCHES)
    print(f"upscale_batch: {imgs.shape} -> {out.shape} {out.dtype}, "
          f"launches {launches}")
    if launches != {"gather_fold_contract": 8, "tail_assemble": 1}:
        raise RuntimeError(f"main path launches {launches}; expected 8 "
                           "gather_fold_contract and 1 tail_assemble")
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

    k1 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for site, (tab, base, wt, C, u) in zip(sites, k1_calls):
        Np = base.shape[0]
        rows = torch.unique(base).numel()
        nbytes = rows * C * u + 4 * Np + 4 * C * Np + 4 * u * Np
        t = {
            "ms": _cuda_ms(torch, lambda: tk.gather_fold_contract(
                tab, base, wt, C=C, u=u), 20),
            "plain_ms": _cuda_ms(torch, lambda: tk.gather_fold_contract_plain(
                tab, base, wt, C=C, u=u), 3),
            "bound_ms": nbytes / HBM_BYTES_PER_MS,
            "library_ms": _cuda_ms(torch, lambda: torch.einsum(
                "cn,ncu->un", wt, tab[base.long()].view(Np, C, u).float()),
                3),
        }
        for key in k1:
            k1[key] += t[key]
        print(f"K1 {site}: C={C} u={u} Np={Np} rows={rows} "
              + " ".join(f"{k}={v:.4f}" for k, v in t.items())
              + f" gathered_bytes={Np * C * u}")
    nmodes = len(folded) + len(quads)
    words = bc * kw["h"] * SCALE * wp
    k2 = {
        "ms": _cuda_ms(torch, lambda: tk.tail_assemble(folded, quads, **kw),
                       20),
        "plain_ms": _cuda_ms(torch, lambda: tk.tail_assemble_plain(
            folded, quads, bc=bc, h=kw["h"], wp=wp, scale=kw["scale"],
            davg=kw["davg"]), 3),
        "bound_ms": words * (4 * 4 * nmodes * 4 + 4) / HBM_BYTES_PER_MS,
    }
    print("K2 tail_assemble: " + " ".join(f"{k}={v:.4f}"
                                          for k, v in k2.items())
          + " library_ms=none (no single torch call computes it)")
    _profile(torch, cascade, dev_ms)

    print(json.dumps({"kernels": [
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
    ]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

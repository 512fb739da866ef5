"""Run one cell of the port's benchmark on the card.

    python3 bench_gpu/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Standard error gets the card's name and
power limit, the set-up's phases, the window, and last each number that
decides `correct` beside its limit; the last line of standard output is
the result's JSON object.  Exits 2 without a result where torch sees no
CUDA device or fewer than the cell asks for, and 3 where JAX, jaxlib,
flax or the JAX package is loaded once the window has closed.  Every
cache goes under `.bench_cache/` in the checkout; the port builds its
kernels into `mulut_tpu_torch/ops/_build/` there.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that the run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "mulut_tpu")


def process_start() -> float:
    """perf_counter() value of this process's start, from /proc (clock
    ticks), or of this module's first line where /proc has none."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return T_START


def pin_caches() -> None:
    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"not read ({e})"
    return f"card (name, power.limit): {out}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_process = process_start()
    pin_caches()
    # the checkout's root, not this script's folder, is where imports start
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != here]

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    import torch

    from bench_gpu import harness

    log(f"process start to imports done: "
        f"{time.perf_counter() - t_process:.3f} s")
    chips = harness.cell_spec(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"refused: the cell needs {chips} CUDA device(s), torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    t = time.perf_counter()
    log(card_line() + f" (read in {time.perf_counter() - t:.3f} s)")
    result = harness.run_cell(args.workload, seed=args.seed,
                              seconds=args.seconds, traced=bool(args.trace),
                              device="cuda", t_process=t_process, log=log)
    found = loaded_forbidden()
    if found:
        log(f"refused: the run loaded {', '.join(found)}")
        return 3
    for k, c in result["check"].items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

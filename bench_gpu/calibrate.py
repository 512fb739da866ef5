"""Readings of the correctness numbers over many seeds: the program as
each cell runs it, and the cell's control, the reference at the next
precision down in the program's place (`reference/<kind>.py` `Control`).
The limits in `workloads/<cell>.json` are set between the two (PERF.md
gives the readings).

    python3 bench_gpu/calibrate.py --cell dense64_dev_540p_b8 \
        --variant program --seeds 101-112 --seconds 2

prints one JSON line per seed.  Each seed is one `harness.run_cell` of
the cell, untraced, with a window of `--seconds`: set-up, warm-up, the
window, and the check of as many batches as a run compares.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from bench_gpu import check, harness  # noqa: E402


def readings_over_seeds(cell: str, seeds, *, variant: str = "program",
                        seconds: float = 2.0, device="cuda",
                        overrides: dict | None = None,
                        root: Path = harness.ROOT, log=lambda m: None):
    """Yield one record per seed: the numbers beside their limits and the
    judgement."""
    build = None
    if variant == "control":
        cfg = harness.cell_spec(cell, root)["config"]
        build = check.reference_kind(cfg).Control
    for seed in seeds:
        r = harness.run_cell(cell, seed=seed, seconds=seconds, traced=False,
                             device=device, overrides=overrides, build=build,
                             log=log, root=root)
        yield {"cell": cell, "variant": variant, "seed": seed,
               "check": r["check"], "correct": r["correct"],
               "failed": r["failed"], "batches": r["attempted"]}


def _seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--variant", choices=("program", "control"),
                    default="program")
    ap.add_argument("--seeds", required=True, help="e.g. 101-112,200")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--warmup", type=int, default=None,
                    help="warm-up batches, if not the cell's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("refused: no CUDA device", file=sys.stderr)
        return 2
    overrides = (None if args.warmup is None
                 else {"cell": {"warmup_batches": args.warmup}})
    for rec in readings_over_seeds(args.cell, _seeds(args.seeds),
                                   variant=args.variant,
                                   seconds=args.seconds,
                                   overrides=overrides):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

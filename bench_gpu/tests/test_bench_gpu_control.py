"""On the card, at each cell's own size: the program comes out correct
and its control (the reference at the next precision down in the
program's place, `reference/<kind>.py` `Control`) does not, on three
seeds each.

    python3 -m pytest bench_gpu/tests/test_bench_gpu_control.py -m chip
"""

import json

import pytest

from bench_gpu import calibrate, harness

CELLS = tuple(w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"])
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.chip
@pytest.mark.parametrize("variant", ["program", "control"])
@pytest.mark.parametrize("cell", CELLS)
def test_control_separates(cell, variant, card):
    # the control runs the reference: one batch warms it up, and a longer
    # window holds as many batches as a run compares
    control = variant == "control"
    recs = list(calibrate.readings_over_seeds(
        cell, SEEDS, variant=variant, seconds=12.0 if control else 2.0,
        device=card,
        overrides={"cell": {"warmup_batches": 1}} if control else None))
    for r in recs:
        print(r)
    assert all(r["correct"] == (not control) for r in recs)

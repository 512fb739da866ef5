"""`BENCHMARK.json` and the files it names, against the rules a benchmark
file keeps: names and units, files found by name, the run-time budget."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench_gpu"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_and_paths():
    assert set(SPEC) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_text(w) for w in SPEC["command"])
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_keys():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic",
                                       "chips", "why"})):
        for e in SPEC[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert _text(e["why"])
    for e in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(e["name"]) and e["name"] not in seen
        seen.add(e["name"])
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in SPEC["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert "setup_s" in {e["name"] for e in SPEC["end_to_end"]}
    for e in SPEC["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _text(e["layer"])
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_configs_found_by_name():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench_gpu/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["weights"] == "seed" or (ROOT / cfg["weights"]).is_file()
        assert (BENCH / "work" / f"{cfg['kind']}.py").is_file()
        assert (BENCH / "reference" / f"{cfg['kind']}.py").is_file()
        assert _text(c["source"])


def test_cells_found_by_name():
    from bench_gpu.traffic import TRAFFIC_KEYS

    pairs = set()
    for w in SPEC["workloads"]:
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert set(TRAFFIC_KEYS) <= set(traffic)
        cell = json.loads(
            (BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert (BENCH / "entries" / f"{cell['entry']}.py").is_file()
        assert cell["limits"] and cell["check_batches"] >= 1


def test_every_cell_reports_enough():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {e["name"]: e for e in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for c in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or \
                c in e2e[m["moves"]]["workloads"]
    for c in cells:
        assert any(c in m["workloads"] for m in SPEC["per_layer"])
        reported = [e for e in SPEC["end_to_end"]
                    if "workloads" not in e or c in e["workloads"]]
        assert len(reported) >= 2


@pytest.mark.parametrize("cells", [len(SPEC["workloads"]), 24])
def test_check_fits_its_time(cells):
    """2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s a cell to
    compile, 1,200 s spare: under 43,200 s, at today's cells and at 24."""
    runs = 2 + 14 * cells
    total = runs * (SPEC["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200

"""The port's benchmark: one cell of `BENCHMARK.json` per run of `run.py`.

Everything a cell needs is found by name: `configs/<config>.json`,
`traffic/<traffic>.json`, `workloads/<cell>.json`, `entries/<entry>.py`
and `metrics/<metric>.py`.  The yardstick (`traffic.py`, `work.py`,
`tracing.py`, `check.py`, `reference/`) imports nothing of the program.
"""

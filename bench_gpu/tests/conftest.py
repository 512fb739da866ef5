"""Settings of the benchmark's own tests (not collected with `tests/`):

    python -m pytest bench_gpu/tests -q            # on the CPU
    python3 -m pytest bench_gpu/tests -q -m chip   # on the card

Tests marked `chip` need the CUDA card; they decide inside the test
whether there is one and skip elsewhere."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs the CUDA card; skips where there is none")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small torch ops on the CPU run fastest on one thread when several
    test processes share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tiny():
    """A cell's traffic and workload cut to a CPU-sized rehearsal.  Warm-up
    ends on the pool's last batch, so a stale answer carried out of it
    never belongs to the window's first batch, however short the window."""
    return {"traffic": {"height": 12, "width": 20, "pool": 4,
                        "frames_per_batch": 2},
            "cell": {"warmup_batches": 2, "trace_batches": 2,
                     "check_batches": 2}}

"""The per-layer readers on a small canned Chrome trace."""

import json

import pytest

from bench_gpu import harness, tracing

WORK = {"k1_bound_s": 1e-4, "k2_bound_s": 2e-4, "k4_bound_s": 5e-4,
        "step_bound_s": 1e-4}
PORT = tracing.port_kernels(harness.ROOT)


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def canned_events():
    """Two batches of 1,000 us each (host spans), with device work:
    batch 1: K1 200 us, glue 100 us, K2 100 us; batch 2: K4 300 us, a
    DtoH copy 100 us overlapping a glue kernel 50 us; one kernel outside
    the window."""
    ann = "user_annotation"
    return [
        _x("bench.batch", ann, 1000, 1000), _x("bench.call", ann, 1000, 600),
        _x("bench.sync", ann, 1600, 400),
        _x("bench.batch", ann, 2000, 1000), _x("bench.call", ann, 2000, 900),
        _x("void window_fold_kernel<16>(int const*, signed char const*)",
           "kernel", 1100, 200),
        _x("void at::native::vectorized_elementwise_kernel<4>(int)",
           "kernel", 1300, 100),
        _x("void tail_assemble_kernel(TailDesc, unsigned int*, long long)",
           "kernel", 1500, 100),
        _x("void dense_kernel<64, 0, 1, false>(DenseParams)", "kernel",
           2100, 300),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 2500, 100),
        _x("void at::native::elementwise_kernel<128>(int)", "kernel",
           2550, 50),
        _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 2700, 10),
        _x("gpu_user_annotation", "gpu_user_annotation", 1000, 2000),
        _x("void dense_kernel<64, 0, 0, false>(DenseParams)", "kernel",
           5000, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 1090, 5),
    ]


@pytest.fixture
def ctx():
    return tracing.TraceContext(canned_events(), n_batches=2, work=WORK,
                                port_kernels=PORT, init_s=1.25)


def read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def test_window_and_busy(ctx):
    assert ctx.window_s == pytest.approx(2000e-6)
    # merged: 1100-1400, 1500-1600, 2100-2400, 2500-2600, 2700-2710
    assert ctx.busy_s == pytest.approx(810e-6)
    assert read("idle_pct", ctx) == pytest.approx(100 * (1 - 810 / 2000))


def test_kernel_groups(ctx):
    assert ctx.kernel_s(("window_fold_kernel",)) == pytest.approx(100e-6)
    assert read("k1_roofline_pct", ctx) == pytest.approx(100.0)
    assert read("k2_roofline_pct", ctx) == pytest.approx(400.0)
    assert read("k4_roofline_pct", ctx) == pytest.approx(
        100 * 5e-4 / 150e-6)
    assert read("glue_ms.lut", ctx) == pytest.approx(0.075)
    assert read("glue_ms.net", ctx) == pytest.approx(0.075)
    assert read("init_s", ctx) == 1.25
    assert read("mfu_pct", ctx) == pytest.approx(100 * 1e-4 / 1e-3)


def test_absent_kernels_read_nothing():
    events = [e for e in canned_events() if "dense" not in e["name"]
              and "at::" not in e["name"]]
    ctx = tracing.TraceContext(events, n_batches=2, work=WORK,
                               port_kernels=PORT, init_s=0.0)
    assert read("k4_roofline_pct", ctx) is None
    assert read("glue_ms.net", ctx) is None


def test_breakdown(ctx):
    b = ctx.breakdown()
    ops = dict(b["device_ops"])
    assert ops["dense_kernel<64, 0, 1, false>"] == pytest.approx(300e-6)
    assert ops["Memcpy DtoH"] == pytest.approx(100e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    # 1600-2100 (mid in the sync span), 2710-3000 (mid in the call)
    assert b["idle_gaps"][0] == ["bench.sync after tail_assemble_kernel",
                                 pytest.approx(500e-6)]
    assert b["idle_gaps"][1] == ["bench.call after Memcpy DtoD",
                                 pytest.approx(290e-6)]


def test_short_name():
    assert tracing.short_name(
        "void ns::k<a<b>, 3>(int, float)") == "ns::k<a<b>, 3>"
    assert tracing.short_name(
        "void (anonymous namespace)::window_fold_kernel<16>(int const*)"
    ) == "(anon)::window_fold_kernel<16>"


def test_load_events(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": canned_events()
                             + [{"ph": "i", "name": "x"}]}))
    assert len(tracing.load_events(str(p))) == len(canned_events())


def test_port_kernels_from_the_sources():
    assert {"window_fold_kernel", "window_quad_sum_kernel",
            "tail_assemble_kernel", "dense_kernel", "plain_kernel",
            "plain_wide_kernel", "plain_w8a8_kernel",
            "gather_fold_contract_kernel"} <= set(PORT)
    assert "__launch_bounds__" not in PORT


def test_port_kernels_parse(tmp_path):
    csrc = tmp_path / "mulut_tpu_torch" / "ops" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "a.cu").write_text(
        "template <int NF>\n__global__ void __launch_bounds__(threads<NF>(),"
        " 1)\nk_one(const P p) {\n}\n"
        "__global__ void k_two(int* __restrict__ x, int n) { }\n")
    assert tracing.port_kernels(tmp_path) == ("k_one", "k_two")

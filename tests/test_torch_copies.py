"""The port's copies of the JAX package's pure-Python/NumPy pieces, and its
import hygiene.

`mulut_tpu_torch` keeps its own copies of `ops/taps.py`, the NumPy table
builders of `ops/simplex_tables.py` (rank chains and Lehmer codes too),
`utils/lut_io.py`, the resize weight builders of `ops/resize.py`,
`window_offsets` of `ops/unit_kernel.py`, the YCbCr constants and
metrics of `utils/metrics.py`, the NumPy calibration and fixed-point code
of `ops/quant.py`, and, for the training half,
`lut_grid` of `pipelines/transfer.py`, the decision tables and comparison
code of `ops/simplex.py`, the synthetic images of `data/synthetic.py`
and `cosine_lr` of `pipelines/train.py` (importing them from
`mulut_tpu` would load JAX).  Tolerance: exact equality throughout —
these are integer tables, permutations, constants and the same NumPy
arithmetic — except `cosine_lr`, which the port evaluates in float64 on
the host and JAX in float32 on the device (XLA rounds the cosine's
argument to float32): within relative 1e-6 at every step (measured
5.7e-7 at total 1,000).  Importing the port loads neither JAX
nor PIL (the card's machine has no PIL).
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mulut_tpu.models.blocks import init_mulut_unit as jax_init_unit
from mulut_tpu.ops import quant as jquant
from mulut_tpu.ops import resize as jresize
from mulut_tpu.ops import simplex_tables as jst
from mulut_tpu.ops import taps as jtaps
from mulut_tpu.ops import unit_kernel as juk
from mulut_tpu.data import synthetic as jsyn
from mulut_tpu.ops import simplex as jsx
from mulut_tpu.utils import lut_io as jio
from mulut_tpu.utils import metrics as jmetrics
from mulut_tpu_torch.data import synthetic as tsyn
from mulut_tpu_torch.ops import simplex as tsx
from mulut_tpu_torch.ops import quant as tquant
from mulut_tpu_torch.ops import resize as tresize
from mulut_tpu_torch.ops import simplex_tables as tst
from mulut_tpu_torch.ops import taps as ttaps
from mulut_tpu_torch.ops import unit_kernel as tuk
from mulut_tpu_torch.utils import lut_io as tio
from mulut_tpu_torch.utils import metrics as tmetrics

jtransfer = importlib.import_module("mulut_tpu.pipelines.transfer")
jtrain = importlib.import_module("mulut_tpu.pipelines.train")
ttransfer = importlib.import_module("mulut_tpu_torch.pipelines.transfer")
ttrain = importlib.import_module("mulut_tpu_torch.pipelines.train")

REPO = Path(__file__).resolve().parents[1]
MODES = "sdyeho"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_taps_constants_equal():
    assert ttaps.TAPS == jtaps.TAPS
    assert ttaps.PAD == jtaps.PAD


@pytest.mark.parametrize("mode", list(MODES))
def test_taps_functions_equal(mode):
    assert ttaps.mode_taps(mode) == jtaps.mode_taps(mode)
    assert ttaps.mode_pad(mode) == jtaps.mode_pad(mode)
    assert ttaps.fold_geometry(mode) == jtaps.fold_geometry(mode)
    for r in range(-1, 6):
        assert ttaps.rotated_taps(mode, r) == jtaps.rotated_taps(mode, r)


@pytest.mark.parametrize("up", [1, 2, 3, 4])
def test_lane_rotation_perm_equal(up):
    for r in range(4):
        np.testing.assert_array_equal(ttaps.lane_rotation_perm(up, r),
                                      jtaps.lane_rotation_perm(up, r))


def test_decision_tables_equal():
    assert tst._BRANCHES == jst._BRANCHES
    np.testing.assert_array_equal(tst.weight_coeffs(), jst.weight_coeffs())
    for L in (5, 9, 17, 33):
        np.testing.assert_array_equal(tst.corner_offsets(L),
                                      jst.corner_offsets(L))
    for geo_mode in "sde":
        for _, sigma in jtaps.fold_geometry(geo_mode):
            np.testing.assert_array_equal(tst._mode_mask_perm(sigma),
                                          jst._mode_mask_perm(sigma))


@pytest.mark.parametrize("interval,v", [(6, 1), (6, 16), (5, 4), (4, 1)])
def test_expand_and_fold_lut_equal(interval, v):
    L = 2 ** (8 - interval) + 1
    rng = np.random.default_rng(interval * 10 + v)
    lut = rng.integers(-127, 128, (L ** 4, v)).astype(np.int8)
    np.testing.assert_array_equal(tst.expand_lut(lut, interval),
                                  jst.expand_lut(lut, interval))
    up = int(round(v ** 0.5))
    perms = [jtaps.lane_rotation_perm(up, r) for r in range(4)]
    for mode in "sde":
        geo = jtaps.fold_geometry(mode)
        for p in (None, perms):
            np.testing.assert_array_equal(
                tst.fold_lut(lut, geo, p, interval),
                jst.fold_lut(lut, geo, p, interval))


def test_rank_chain_and_lehmer_equal():
    """`rank_chain_masks`, `lehmer_of_ranks` (over every rank tuple, ties
    and invalid ones included) and `comparison_code` of
    `ops/simplex_tables.py`."""
    import itertools

    got, want = tst.rank_chain_masks(), jst.rank_chain_masks()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    r = np.array(list(itertools.product(range(4), repeat=4))).T
    np.testing.assert_array_equal(tst.lehmer_of_ranks(*r),
                                  jst.lehmer_of_ranks(*r))
    f = np.random.default_rng(3).integers(0, 4, (4, 300))
    np.testing.assert_array_equal(tst.comparison_code(*f),
                                  jst.comparison_code(*f))


def test_lut_io_equal(tmp_path):
    assert tio.lut_key(2, "y") == jio.lut_key(2, "y")
    assert tio.parse_stage_key("s12_y") == jio.parse_stage_key("s12_y")
    assert (tio.lut_filename("LUT_ft", 4, 4, 1, "s")
            == jio.lut_filename("LUT_ft", 4, 4, 1, "s"))
    rng = np.random.default_rng(1)
    for s, v in ((1, 1), (2, 16)):
        for m in "sdy":
            tio.save_lut(str(tmp_path), rng.integers(-127, 128, (625, v)),
                         name="LUT_ft", scale=4, interval=6, stage=s, mode=m)
    kw = dict(stages=2, modes="sdy", scale=4, interval=6)
    got = tio.load_luts(str(tmp_path), **kw)
    want = jio.load_luts(str(tmp_path), **kw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("modes", ["sdy", "s", "y", "sdeyho", "eh"])
def test_window_offsets_equal(modes):
    assert tuk.window_offsets(modes) == juk.window_offsets(modes)


@pytest.mark.parametrize("n_in,n_out", [(270, 1080), (9, 36), (5, 10),
                                        (12, 5)])
def test_bicubic_matrix_equal(n_in, n_out):
    np.testing.assert_array_equal(tresize._bicubic_matrix_np(n_in, n_out),
                                  jresize._bicubic_matrix_np(n_in, n_out))
    x = np.linspace(-3, 3, 61)
    np.testing.assert_array_equal(tresize._keys_cubic(x),
                                  jresize._keys_cubic(x))


def test_ycbcr_constants_equal():
    for name in ("_YCBCR_T", "_YCBCR_O"):
        got, want = getattr(tmetrics, name), getattr(jmetrics, name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 5, 17])
def test_quant_grid_equal(n):
    got, want = tquant._grid4(n), jquant._grid4(n)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nf", [16, 64])
def test_quant_calibration_and_fixed_point_equal(nf):
    import jax

    unit = jax.tree_util.tree_map(
        np.asarray, jax_init_unit(jax.random.PRNGKey(nf), nf=nf, upscale=4,
                                  dense=False, depth=2))
    got = tquant.calibrate_plain_unit(unit)
    want = jquant.calibrate_plain_unit(unit)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    rng = np.random.default_rng(nf)
    hcq = (rng.random((2, 3, nf)) * 10.0 ** rng.uniform(-6, 1, (2, 3, nf))
           ).astype(np.float32)
    hbq = (rng.standard_normal((2, 3, nf)) * 100).astype(np.float32)
    for g, w in zip(tquant._fixed_point(hcq, hbq, nf),
                    jquant._fixed_point(hcq, hbq, nf)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("interval", [3, 4, 6])
def test_lut_grid_equal(interval):
    got, want = ttransfer.lut_grid(interval), jtransfer.lut_grid(interval)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_simplex_tables_and_codes_equal():
    for L in (3, 9, 17):
        for g, w in zip(tsx._tables(L), jsx._tables(L)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    f = np.random.default_rng(2).integers(0, 16, (4, 500))
    import torch

    got = tsx._comparison_code(*(torch.as_tensor(x) for x in f)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsx._comparison_code(*f)))


@pytest.mark.parametrize("size,scale", [(32, 4), (48, 3)])
def test_synthetic_images_equal(size, scale):
    got = tsyn._synth_image(np.random.default_rng(size), size)
    want = jsyn._synth_image(np.random.default_rng(size), size)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsyn._bicubic_down(got, scale),
                                  jsyn._bicubic_down(want, scale))


def test_metrics_functions_equal():
    rng = np.random.default_rng(8)
    a = rng.integers(0, 256, (19, 23, 3)).astype(np.uint8)
    b = rng.integers(0, 256, (19, 23, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tmetrics.rgb2ycbcr(a),
                                  jmetrics.rgb2ycbcr(a))
    np.testing.assert_array_equal(tmetrics._gaussian_window(),
                                  jmetrics._gaussian_window())
    np.testing.assert_array_equal(tmetrics.modcrop(a, 4),
                                  jmetrics.modcrop(a, 4))
    ya, yb = a[..., 0], b[..., 0]
    assert tmetrics.psnr(ya, yb, 2) == jmetrics.psnr(ya, yb, 2)
    assert tmetrics.ssim(ya, yb) == jmetrics.ssim(ya, yb)
    assert tmetrics.psnr_ssim_y(a, b, 4) == jmetrics.psnr_ssim_y(a, b, 4)


@pytest.mark.parametrize("lr1", [1e-4, -1.0])
def test_cosine_lr_values(lr1):
    import jax

    total = 1000
    want_fn = jax.jit(jtrain.cosine_lr(1e-3, lr1, total))
    got_fn = ttrain.cosine_lr(1e-3, lr1, total)
    for k in range(0, total + 1, 7):
        want = float(want_fn(np.int32(k)))
        got = float(np.float32(got_fn(k)))
        assert abs(got - want) <= 1e-6 * want, (k, got, want)


def test_import_loads_no_pil():
    """Importing every module of the port leaves PIL out of sys.modules:
    image IO imports it inside its functions."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "mulut_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print([m for m in sys.modules if m == 'PIL' or "
        "m.startswith('PIL.')])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "[]"


def test_import_loads_no_jax():
    """Importing every module of the port, and loading each script of
    `sr_torch/` by path (its `__main__` block not run), leaves `jax` and
    `mulut_tpu` (exactly, or as a `mulut_tpu.` prefix) out of
    sys.modules."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "mulut_tpu_torch").rglob("*.py")
    )
    scripts = sorted(str(p) for p in (REPO / "sr_torch").glob("*.py"))
    assert len(scripts) == 10
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"for i, path in enumerate({scripts!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'_script{i}', "
        "path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'mulut_tpu' or m.startswith('mulut_tpu.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "[]"


def test_sources_import_no_jax():
    files = list((REPO / "mulut_tpu_torch").rglob("*.py"))
    files += sorted((REPO / "sr_torch").glob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if not s.startswith(("import ", "from ")):
                continue
            words = s.replace(",", " ").split()
            assert "jax" not in words and not any(
                w.startswith("jax.") for w in words), (f, line)
            assert "mulut_tpu" not in words and not any(
                w.startswith("mulut_tpu.") for w in words), (f, line)


def _flag_table(options_cls):
    """Every flag of an options class: (option strings, dest, default,
    type, choices, action kind, help), in the parser's order."""
    import argparse

    parser = options_cls().initialize(argparse.ArgumentParser())
    return [(tuple(a.option_strings), a.dest, a.default, a.type, a.choices,
             type(a).__name__, a.help)
            for a in parser._actions if a.dest != "help"]


@pytest.mark.parametrize("name", ["BaseOptions", "TrainOptions",
                                  "TestOptions"])
def test_options_flag_table_equal(name):
    """`utils/options.py`'s flags are JAX's, in JAX's order, with
    `--device` (default None: the card) as the one addition, after
    `--debug`."""
    from mulut_tpu.utils import options as jopt
    from mulut_tpu_torch.utils import options as topt

    want = _flag_table(getattr(jopt, name))
    got = _flag_table(getattr(topt, name))
    device = [row for row in got if row[1] == "device"]
    assert len(device) == 1
    assert device[0][:5] == (("--device",), "device", None, str, None)
    at = got.index(device[0])
    assert got[at - 1][1] == "debug"
    assert got[:at] + got[at + 1:] == want

"""The port's command line, against the JAX package on the CPU: the flag
set (`utils/options.py`), step 4's CLI functions (`run_test`,
`eval_dataset`, `process_single_image`), `sr_torch/4_test_lut.py` and
`5_test_lut.py` as processes, the PNG codec (`utils/imgio.py`) and the
trace readers of `utils/profiling.py`.

Tolerances: exact throughout.  The options are the same values; the LUT
cascade is byte-identical across packages (tests/test_torch_evaluate.py),
so the result images are the same pixels and their PSNR/SSIM the same
NumPy arithmetic on them; the codec decodes PIL's files to PIL's arrays
and writes PIL's files byte for byte (PIL's filters and deflate settings,
one zlib here), so the two packages' result PNGs are the same bytes.

Shared per module: one folder of random int8 LUTs (x4 `sdy`, 2 stages,
interval 6: tables of 625 rows, which keep the CPU path's table builds
short; seed 15) and one benchmark tree of three small images (`bench`).
"""

import argparse
import gzip
import json
import os
import pickle
import struct
import subprocess
import sys
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from mulut_tpu.data.degrade import bicubic_lr
from mulut_tpu.data.synthetic import _synth_image
from mulut_tpu.pipelines import evaluate as jev
from mulut_tpu.utils import imgio as jio
from mulut_tpu.utils import options as jopt
from mulut_tpu_torch.pipelines import evaluate as tev
from mulut_tpu_torch.utils import imgio as tio
from mulut_tpu_torch.utils import options as topt
from mulut_tpu_torch.utils.lut_io import lut_filename

REPO = Path(__file__).resolve().parents[1]
INTERVAL = 6
#: HR sizes of the benchmark tree (multiples of 4; two share a bucket of 16)
SIZES = [(40, 44), (36, 48), (28, 28)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """{"luts": a LUT folder, "test": a benchmark root with Set5}."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(15)
    luts = root / "sr_x4sdy"
    luts.mkdir()
    for stage, v in ((1, 1), (2, 16)):
        for mode in "sdy":
            np.save(luts / lut_filename("LUT_ft", 4, INTERVAL, stage, mode),
                    rng.integers(-127, 128, (5 ** 4, v)).astype(np.int8))
    for k, (h, w) in enumerate(SIZES):
        hr = _synth_image(rng, max(h, w))[:h, :w]
        jio.save_image(str(root / "test" / "Set5" / "HR" / f"im{k}.png"), hr)
        jio.save_image(str(root / "test" / "Set5" / "LR_bicubic" / "X4"
                           / f"im{k}.png"), bicubic_lr(hr, 4))
    return {"luts": str(luts), "test": str(root / "test"), "root": root}


def _test_opt(bench, results, **kw):
    base = dict(scale=4, stages=2, modes="sdy", interval=INTERVAL,
                expDir=bench["luts"], lutName="LUT_ft",
                testDir=bench["test"], resultRoot=str(results),
                evalBucket=0, evalBand=0, gpuNum=1)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.fixture(scope="module")
def jax_runs(bench, tmp_path_factory):
    """JAX's `run_test` per bucket, computed once per module: {bucket:
    (summary, result root)}."""
    out = {}
    for bucket in (0, 16):
        root = tmp_path_factory.mktemp(f"jax{bucket}")
        out[bucket] = (jev.run_test(_test_opt(bench, root,
                                              evalBucket=bucket)), root)
    return out


def _pixels(folder):
    return {f: np.array(Image.open(os.path.join(folder, f)))
            for f in sorted(os.listdir(folder))}


@pytest.mark.parametrize("bucket", [0, 16])
def test_run_test_and_eval_dataset_equal_jax(bench, jax_runs, tmp_path,
                                             capsys, bucket):
    want, jroot = jax_runs[bucket]
    got = tev.run_test(_test_opt(bench, tmp_path / "torch",
                                 evalBucket=bucket), device="cpu")
    assert got == want and list(got) == ["Set5"]
    line = "Dataset Set5 | AVG LUT PSNR: {:.2f} SSIM: {:.4f}".format(
        *want["Set5"])
    assert capsys.readouterr().out.splitlines()[-1] == line
    sub = os.path.join("sr_x4sdy", "Set5", "X4")
    jp = _pixels(jroot / sub)
    tp = _pixels(tmp_path / "torch" / sub)
    assert list(tp) == list(jp) == [f"im{k}_LUT_ft_2bit.png"
                                    for k in range(len(SIZES))]
    for f in jp:
        assert tp[f].dtype == np.uint8 and np.array_equal(tp[f], jp[f]), f
        assert (tmp_path / "torch" / sub / f).read_bytes() == (
            jroot / sub / f).read_bytes()
    # the port's files: the same bytes at either bucket
    if bucket:
        ref = tmp_path / "ref"
        tev.run_test(_test_opt(bench, ref), device="cpu")
        for f in tp:
            assert (ref / sub / f).read_bytes() == (
                tmp_path / "torch" / sub / f).read_bytes()


def test_eval_dataset_per_image_scores_equal(bench):
    kw = dict(stages=2, modes="sdy", scale=4, interval=INTERVAL)
    want = jev.eval_dataset(jev.LutEvaluator.from_folder(bench["luts"], **kw),
                            bench["test"], "Set5", interval=INTERVAL)
    got = tev.eval_dataset(tev.LutEvaluator.from_folder(
        bench["luts"], device="cpu", **kw), bench["test"], "Set5",
        interval=INTERVAL)
    assert got == want and len(got) == len(SIZES)


def test_process_single_image_equal(bench, tmp_path):
    lr = os.path.join(bench["test"], "Set5", "LR_bicubic", "X4", "im1.png")
    gt = os.path.join(bench["test"], "Set5", "HR", "im1.png")
    j_img, j_m = jev.process_single_image(lr, bench["luts"],
                                          str(tmp_path / "j.png"), gt_path=gt,
                                          interval=INTERVAL)
    t_img, t_m = tev.process_single_image(lr, bench["luts"],
                                          str(tmp_path / "t.png"), gt_path=gt,
                                          interval=INTERVAL, device="cpu")
    assert np.array_equal(t_img, j_img) and t_m == j_m
    assert np.array_equal(np.array(Image.open(tmp_path / "t.png")), j_img)
    t2, none = tev.process_single_image(lr, bench["luts"], interval=INTERVAL,
                                        device="cpu")
    assert none is None and np.array_equal(t2, j_img)


def test_run_test_runs_where_opt_device_says(bench, tmp_path):
    """`run_test` takes `opt.device` (the `--device` flag) when no device
    is passed, and runs on the card when both are None."""
    opt = _test_opt(bench, tmp_path, device="cpu")
    assert tev.run_test(opt) == tev.run_test(opt, device="cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tev.run_test(_test_opt(bench, tmp_path, device=None))


def _script(name, *args, cwd):
    """Run a script of `sr_torch/` as a process, torch on one thread (as
    this module's own ops)."""
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, str(REPO / "sr_torch" / name), *args], cwd=cwd,
        env=env, capture_output=True, text=True, timeout=300)


def test_step4_scripts_print_the_in_process_summary(bench, jax_runs,
                                                    tmp_path):
    want = jax_runs[0][0]["Set5"]
    line = "Dataset Set5 | AVG LUT PSNR: {:.2f} SSIM: {:.4f}".format(*want)
    res = _script("4_test_lut.py", "-e", bench["luts"], "--testDir",
                  bench["test"], "--resultRoot", str(tmp_path / "r4"),
                  "--interval", str(INTERVAL), "--device", "cpu",
                  cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.splitlines() == [line]
    assert (Path(bench["luts"]) / "code" / "utils" / "options.py").exists()
    lr = os.path.join(bench["test"], "Set5", "LR_bicubic", "X4", "im0.png")
    gt = os.path.join(bench["test"], "Set5", "HR", "im0.png")
    res = _script("5_test_lut.py", "--image", lr, "--output",
                  str(tmp_path / "sr.png"), "--gt", gt, "-e", bench["luts"],
                  "--interval", str(INTERVAL), "--device", "cpu", "--debug",
                  cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    img, m = jev.process_single_image(lr, bench["luts"], gt_path=gt,
                                      interval=INTERVAL)
    assert res.stdout.splitlines() == [
        f"Processed {lr} -> {tmp_path / 'sr.png'} shape={img.shape}",
        f"PSNR: {m[0]:.2f} SSIM: {m[1]:.4f}"]
    assert np.array_equal(tio.load_image(str(tmp_path / "sr.png")), img)


# -- options -----------------------------------------------------------------

ARGVS = {
    "base": (jopt.BaseOptions, topt.BaseOptions, ["-e", "{root}/e1"]),
    "auto": (jopt.TrainOptions, topt.TrainOptions,
             ["--modelRoot", "{root}/models"]),
    "train": (jopt.TrainOptions, topt.TrainOptions,
              ["-e", "{root}/e2", "--batchSize", "16", "--arch", "mxu",
               "--nf", "128", "--trainPrecision", "bf16", "-g", "2",
               "--lr0", "0.002", "--stages", "3", "--modes", "sdyeho"]),
    "train_debug": (jopt.TrainOptions, topt.TrainOptions,
                    ["-e", "{root}/e3", "--debug", "-r", "2"]),
    "test": (jopt.TestOptions, topt.TestOptions,
             ["-e", "{root}/e4", "-i", "1000", "--evalBucket", "32",
              "--evalBand", "64", "-g", "2", "--lutName", "LUT"]),
    "dn": (jopt.TestOptions, topt.TestOptions,
           ["-e", "{root}/e5", "-t", "dn", "-s", "15"]),
    "db": (jopt.TestOptions, topt.TestOptions,
           ["-e", "{root}/e6", "-t", "db", "-q", "40"]),
}


def _parse(cls, argv, root):
    opt = cls().parse([a.format(root=root) for a in argv])
    return {k: (v.replace(str(root), "<root>") if isinstance(v, str) else v)
            for k, v in vars(opt).items()}, opt


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_options_parse_equal_jax(tmp_path, case):
    jcls, tcls, argv = ARGVS[case]
    want, jo = _parse(jcls, argv, tmp_path / "jax")
    got, to = _parse(tcls, argv + ["--device", "cpu"], tmp_path / "torch")
    assert got.pop("device") == "cpu"
    assert got == want
    exp = Path(to.expDir)
    assert exp.is_dir() and (exp / "opt.pkl").exists() == to.isTrain
    if not to.debug:        # the snapshot: the port's sources, not JAX's
        code = exp / "code"
        assert (code / "utils" / "options.py").exists()
        assert (code / "ops" / "csrc" / "window_fold.cu").exists()
        assert not (code / "utils" / "xla_opts.py").exists()
    _, default = _parse(tcls, argv, tmp_path / "default")
    assert default.device is None


def test_opt_pkl_round_trips_across_packages(tmp_path):
    argv = ["-e", str(tmp_path / "e"), "--nf", "32", "--totalIter", "7",
            "--debug"]
    jinst = jopt.TrainOptions()
    jo = jinst.parse(argv)
    assert type(pickle.load(open(tmp_path / "e" / "opt.pkl", "rb"))) is \
        argparse.Namespace
    # JAX's opt.pkl loads in the port, and seeds its defaults
    tinst = topt.TrainOptions()
    loaded = tinst.load_options(types.SimpleNamespace(expDir=jo.expDir))
    assert vars(loaded) == vars(jinst.load_options(jo))
    assert loaded.totalIter == 7
    to = tinst.parse(["-e", jo.expDir, "--load_from_opt_file", "--debug"])
    assert (to.nf, to.totalIter, to.device) == (32, 200, None)
    # the port's opt.pkl is a plain Namespace too, and loads in JAX
    tinst.parse(["-e", str(tmp_path / "t"), "--nf", "16", "--device", "cpu",
                 "--debug"])
    back = jopt.TrainOptions().load_options(
        types.SimpleNamespace(expDir=str(tmp_path / "t")))
    assert type(back) is argparse.Namespace
    assert (back.nf, back.device) == (16, "cpu")


def test_protected_tree_gets_no_side_cars(tmp_path, monkeypatch):
    ref = tmp_path / "reference" / "models" / "sr"
    ref.mkdir(parents=True)
    monkeypatch.setattr(topt, "PROTECTED_ROOTS", (str(tmp_path / "reference"),))
    opt = topt.TrainOptions().parse(["-e", str(ref)])
    assert opt.expDir == str(ref) and list(ref.iterdir()) == []


# -- the PNG codec -----------------------------------------------------------

def _png(arr, kinds):
    """A PNG of `arr` with row y under filter kinds[y % len(kinds)],
    filtered here (PNG spec 9.2) for the decoder's five filter types."""
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    a = arr.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        k = kinds[y % len(kinds)]
        row = a[y]
        up = a[y - 1] if y else np.zeros_like(row)
        left = np.concatenate([np.zeros(c, np.int32), row[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][k]
        rows.append(bytes([k]) + ((row - pred) & 255).astype(np.uint8)
                    .tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


SHAPES = [(9, 11), (7, 5, 2), (13, 17, 3), (6, 9, 4), (1, 1, 3)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_png_codec_matches_pil(tmp_path, shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    noise = rng.integers(0, 256, shape).astype(np.uint8)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    smooth = ((yy * 7 + xx * 3) % 256).astype(np.uint8)
    if len(shape) == 3:
        smooth = np.stack([smooth + 11 * i for i in range(shape[2])], -1)
    for k, arr in enumerate((noise, smooth.astype(np.uint8))):
        pil = tmp_path / f"pil{k}.png"
        Image.fromarray(arr).save(pil)
        assert np.array_equal(tio.read_png(str(pil)), np.array(Image.open(pil)))
        assert np.array_equal(tio.load_image(str(pil)),
                              jio.load_image(str(pil)))
        own = tmp_path / f"own{k}.png"
        tio.save_image(str(own), arr)
        assert np.array_equal(np.array(Image.open(own)), arr)
        assert own.read_bytes() == pil.read_bytes()
        for kinds in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4], [4, 3, 1]):
            f = tmp_path / "filt.png"
            f.write_bytes(_png(arr, kinds))
            assert np.array_equal(np.array(Image.open(f)), arr)
            assert np.array_equal(tio.read_png(str(f)), arr), kinds


def test_png_codec_leaves_other_files_to_pil(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (8, 10, 3)).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "a.jpg", quality=90)
    Image.fromarray(rgb).convert("P").save(tmp_path / "p.png")
    for name in ("a.jpg", "p.png"):
        assert tio.read_png(str(tmp_path / name)) is None
        assert np.array_equal(tio.load_image(str(tmp_path / name)),
                              jio.load_image(str(tmp_path / name)))
    tio.save_image(str(tmp_path / "b.jpg"), rgb)
    assert np.array(Image.open(tmp_path / "b.jpg")).shape == rgb.shape
    with pytest.raises(ValueError):
        tio.write_png(str(tmp_path / "x.png"), np.zeros((2, 2, 5), np.uint8))
    monkeypatch.chdir(tmp_path)          # a bare file name: the working dir
    tio.save_image("bare.png", rgb)
    assert np.array_equal(tio.load_image(str(tmp_path / "bare.png")), rgb)


# -- profiling ---------------------------------------------------------------

def _trace_events(rng):
    """(start_us, dur_us, name) of 40 device events on two overlapping
    lanes, seeded."""
    out, t = [], 0.0
    for k in range(40):
        t += float(rng.integers(0, 30))
        out.append((t, float(rng.integers(1, 50)), f"k{k % 5}"))
    return out


def test_profiling_reads_traces_as_jax_does(tmp_path):
    """The same device intervals as a JAX profiler trace (gzip, HLO ops)
    and as a `torch.profiler` Chrome trace (kernels): equal busy, idle and
    gaps, and equal per-name totals."""
    import gzip
    import json

    from mulut_tpu.utils import profiling as jprof
    from mulut_tpu_torch.utils import profiling as tprof

    ev = _trace_events(np.random.default_rng(4))
    jdir = tmp_path / "jax" / "plugins" / "profile" / "run"
    jdir.mkdir(parents=True)
    with gzip.open(jdir / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": [
            {"ph": "X", "ts": s, "dur": d, "name": n,
             "args": {"hlo_category": "x", "long_name": n}}
            for s, d, n in ev] + [{"ph": "X", "ts": 0, "dur": 5,
                                   "name": "host"}]}, f)
    tdir = tmp_path / "torch"
    tdir.mkdir()
    with open(tdir / "trace_1_2.json", "w") as f:
        json.dump({"traceEvents": [
            {"ph": "X", "ts": s, "dur": d, "name": n, "cat": "kernel"}
            for s, d, n in ev] + [{"ph": "X", "ts": 0, "dur": 5,
                                   "name": "aten::add", "cat": "cpu_op"}]},
                  f)
    assert tprof.device_timeline(str(tdir)) == jprof.device_timeline(
        str(tmp_path / "jax"))
    want = {name: ms for ms, name, _ in jprof.op_breakdown(
        str(tmp_path / "jax"))}
    got = {name: ms for ms, name, _ in tprof.op_breakdown(str(tdir))}
    assert got == want and len(got) == 5
    assert sum(n for _, _, n in tprof.op_breakdown(str(tdir))) == 40
    assert tprof.device_timeline(str(tmp_path / "none")) == {}


def test_profiling_trace_and_timer_on_the_cpu(tmp_path, monkeypatch):
    from mulut_tpu_torch.utils import profiling as tprof

    x = torch.arange(64.0).reshape(8, 8)
    with tprof.trace() as prof:                      # no directory: a no-op
        assert prof is None
    monkeypatch.setenv("MULUT_TRACE_DIR", str(tmp_path / "tr"))
    with tprof.trace() as prof:
        with tprof.annotate("matmul"):
            x @ x
    (f,) = os.listdir(tmp_path / "tr")
    assert f.startswith("trace_") and f.endswith(".json")
    with open(tmp_path / "tr" / f) as fh:
        names = [e.get("name") for e in json.load(fh)["traceEvents"]]
    assert "matmul" in names
    kernels, ops = tprof.device_rows(prof)
    assert kernels == [] and tprof.op_breakdown(str(tmp_path / "tr")) == []
    assert 0 < tprof.device_time(lambda a: a @ a, x, n=2, reps=1) < 1.0

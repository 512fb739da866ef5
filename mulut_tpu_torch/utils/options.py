"""Config/flag system with reference CLI parity.

Reproduces the reference's layered argparse surface — flag names, defaults,
expDir auto-numbering, opt.txt/opt.pkl persistence, debug-mode step rewrites,
and source snapshotting (ref: common/option.py:8-199) — so existing command
lines against the reference scripts work unchanged against ours.

A copy of `mulut_tpu.utils.options` with one flag more, `--device` (every
`sr_torch/` script hands it to the entry points it calls; default: the
CUDA card, `--device cpu` for the plain torch path on the host).  The
options stay a plain `argparse.Namespace` of str/int/float/bool/None, so
an `opt.pkl` written by either package loads in the other.
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil
from pathlib import Path


# Trees we must never write side-car artifacts into, even when an expDir
# points inside them (e.g. evaluating directly against the read-only
# reference models with `-e <reference>/models/...`).  Checkpoints and
# results the USER explicitly asks for still go where they said; this guard
# only covers the implicit snapshots (code/, opt.*, val/).  The default is
# the reference artifacts tree, `reference/` beside the repository checkout
# (the JAX package's default in the project's layout); MULUT_PROTECTED_ROOTS
# (os.pathsep-separated) replaces it.
_REFERENCE_TREE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "reference")
PROTECTED_ROOTS = tuple(
    p
    for p in os.environ.get("MULUT_PROTECTED_ROOTS", _REFERENCE_TREE).split(
        os.pathsep
    )
    if p
)


def _in_protected_tree(path: str) -> bool:
    real = os.path.realpath(path)
    for root in PROTECTED_ROOTS:
        root = os.path.realpath(root)
        if real == root or real.startswith(root + os.sep):
            return True
    return False


class BaseOptions:
    isTrain = False

    def __init__(self, debug: bool = False):
        self.initialized = False
        self.debug = debug

    def initialize(self, parser: argparse.ArgumentParser):
        parser.add_argument("--model", type=str, default="SRNets")
        parser.add_argument("--task", "-t", type=str, default="sr")
        parser.add_argument("--scale", "-r", type=int, default=4, help="up scale factor")
        parser.add_argument("--sigma", "-s", type=int, default=25, help="noise level")
        parser.add_argument("--qf", "-q", type=int, default=20, help="deblocking quality factor")
        parser.add_argument("--nf", type=int, default=64, help="number of filters of convolutional layers")
        parser.add_argument("--arch", type=str, default="dense",
                            choices=("dense", "mxu"),
                            help="unit architecture: 'dense' = reference "
                            "dense-concat (common/network.py:62-105); "
                            "'mxu' = TPU-native plain-MLP variant (use "
                            "--nf 128) — same LUT artifacts, higher "
                            "net-mode MFU")
        parser.add_argument("--unitDepth", type=int, default=0,
                            help="hidden matmuls per unit (0 = arch "
                            "default: dense 4, mxu 2)")
        parser.add_argument("--stages", type=int, default=2, help="stages of MuLUT")
        parser.add_argument("--modes", type=str, default="sdy", help="sampling modes to use in every stage")
        parser.add_argument("--interval", type=int, default=4, help="N bit uniform sampling")
        parser.add_argument("--modelRoot", type=str, default="../models")
        parser.add_argument("--expDir", "-e", type=str, default="", help="experiment folder")
        parser.add_argument("--load_from_opt_file", action="store_true", default=False)
        parser.add_argument("--debug", default=False, action="store_true")
        parser.add_argument("--device", type=str, default=None,
                            help="torch device the entry points run on "
                            "(default: the CUDA card; 'cpu' runs the "
                            "kernels' plain torch versions on the host)")
        self.initialized = True
        return parser

    def gather_options(self, args=None):
        parser = argparse.ArgumentParser(
            formatter_class=argparse.ArgumentDefaultsHelpFormatter
        )
        parser = self.initialize(parser)
        opt = parser.parse_args([] if self.debug else args)
        if opt.load_from_opt_file:
            loaded = self.load_options(opt)
            for k, v in sorted(vars(opt).items()):
                if hasattr(loaded, k) and v != getattr(loaded, k):
                    parser.set_defaults(**{k: getattr(loaded, k)})
            opt = parser.parse_args([] if self.debug else args)
        self.parser = parser
        return opt

    def print_options(self, opt) -> str:
        lines = ["----------------- Options ---------------"]
        for k, v in sorted(vars(opt).items()):
            comment = ""
            default = self.parser.get_default(k)
            if v != default:
                comment = f"\t[default: {default}]"
            lines.append("{:>25}: {:<30}{}".format(str(k), str(v), comment))
        lines.append("----------------- End -------------------")
        message = "\n".join(lines)
        print(message)
        return message

    def save_options(self, opt) -> None:
        file_name = os.path.join(opt.expDir, "opt")
        with open(file_name + ".txt", "wt") as f:
            for k, v in sorted(vars(opt).items()):
                comment = ""
                default = self.parser.get_default(k)
                if v != default:
                    comment = f"\t[default: {default}]"
                f.write("{:>25}: {:<30}{}\n".format(str(k), str(v), comment))
        with open(file_name + ".pkl", "wb") as f:
            pickle.dump(opt, f)

    def load_options(self, opt):
        with open(os.path.join(opt.expDir, "opt.pkl"), "rb") as f:
            return pickle.load(f)

    def process(self, opt):
        if "dn" in opt.task:
            opt.flag = opt.sigma
        elif "db" in opt.task:
            opt.flag = opt.qf
        elif "sr" in opt.task:
            opt.flag = opt.scale
        else:
            opt.flag = "0"
        return opt

    def save_code(self) -> None:
        """Snapshot the port's sources (Python and the CUDA kernels'
        sources, not their build) into expDir/code (ref:
        common/option.py:104-110)."""
        import mulut_tpu_torch

        if _in_protected_tree(self.opt.expDir):
            return
        src_dir = os.path.dirname(os.path.abspath(mulut_tpu_torch.__file__))
        trg_dir = os.path.join(self.opt.expDir, "code")
        for f in (p for pat in ("*.py", "*.cu", "*.cuh")
                  for p in Path(src_dir).rglob(pat)):
            if "_build" in f.relative_to(src_dir).parts:
                continue
            rel = f.relative_to(src_dir)
            trg = os.path.join(trg_dir, str(rel))
            os.makedirs(os.path.dirname(trg), exist_ok=True)
            shutil.copy(f, trg, follow_symlinks=False)

    def parse(self, args=None, save: bool = False):
        opt = self.gather_options(args)
        opt.isTrain = self.isTrain
        opt = self.process(opt)

        if opt.expDir == "":
            opt.modelDir = os.path.join(opt.modelRoot, "debug")
            os.makedirs(opt.modelDir, exist_ok=True)
            count = 1
            while os.path.isdir(os.path.join(opt.modelDir, f"expr_{count}")):
                count += 1
            opt.expDir = os.path.join(opt.modelDir, f"expr_{count}")
            os.mkdir(opt.expDir)
        elif not _in_protected_tree(opt.expDir):
            os.makedirs(opt.expDir, exist_ok=True)

        opt.modelPath = os.path.join(opt.expDir, "Model.pth")

        if opt.isTrain:
            opt.valoutDir = os.path.join(opt.expDir, "val")
            if not _in_protected_tree(opt.expDir):
                os.makedirs(opt.valoutDir, exist_ok=True)
                self.save_options(opt)

        if opt.isTrain and opt.debug:
            opt.displayStep = 10
            opt.saveStep = 100
            opt.valStep = 50
            opt.totalIter = 200

        self.opt = opt
        if not opt.debug:
            self.save_code()
        return self.opt


class TrainOptions(BaseOptions):
    isTrain = True

    def initialize(self, parser):
        BaseOptions.initialize(self, parser)
        parser.add_argument("--batchSize", type=int, default=32)
        parser.add_argument("--cropSize", type=int, default=48, help="input LR training patch size")
        parser.add_argument("--trainDir", type=str, default="../data/DIV2K")
        parser.add_argument("--valDir", type=str, default="../data/SRBenchmark")
        parser.add_argument("--startIter", type=int, default=0,
                            help="Set 0 for from scratch, else will load saved params and trains further")
        parser.add_argument("--totalIter", type=int, default=200000, help="Total number of training iterations")
        parser.add_argument("--displayStep", type=int, default=100, help="display info every N iteration")
        parser.add_argument("--valStep", type=int, default=2000, help="validate every N iteration")
        parser.add_argument("--saveStep", type=int, default=2000, help="save models every N iteration")
        parser.add_argument("--lr0", type=float, default=1e-3)
        parser.add_argument("--lr1", type=float, default=1e-4)
        parser.add_argument("--weightDecay", type=float, default=0)
        parser.add_argument("--gpuNum", "-g", type=int, default=1)
        parser.add_argument("--workerNum", "-n", type=int, default=8)
        parser.add_argument("--trainPrecision", type=str, default="f32",
                            choices=["f32", "bf16"],
                            help="forward/backward compute precision; "
                                 "'bf16' keeps f32 master weights and "
                                 "casts the cascade to bfloat16 (the mxu "
                                 "arch's fast-train mode — the dense "
                                 "reference shapes default to exact f32)")
        return parser

    def process(self, opt):
        return opt


class TestOptions(BaseOptions):
    isTrain = False

    def initialize(self, parser):
        BaseOptions.initialize(self, parser)
        parser.add_argument("--loadIter", "-i", type=int, default=200000)
        parser.add_argument("--testDir", type=str, default="../data/SRBenchmark")
        parser.add_argument("--resultRoot", type=str, default="../results")
        parser.add_argument("--lutName", type=str, default="LUT_ft")
        parser.add_argument("--evalBucket", type=int, default=0,
                            help="round eval shapes up to multiples of this "
                                 "(one compiled program serves many image "
                                 "sizes; output bit-identical; 0 = exact "
                                 "shapes)")
        parser.add_argument("--evalBand", type=int, default=0,
                            help="row-band large images through the cascade "
                                 "in slabs of this many rows (bounds HBM "
                                 "temporaries for >1080p inputs; output "
                                 "bit-identical; 0 = untiled)")
        parser.add_argument("--gpuNum", "-g", type=int, default=1,
                            help="shard bucketed eval batches over this many "
                                 "devices (the DataParallel surface of "
                                 "ref: sr/1_train_model.py:141-142 extended "
                                 "to step 4; bit-identical)")
        return parser

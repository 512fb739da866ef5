"""Entry points: evaluation (step 4), training, LUT transfer and LUT
fine-tuning (steps 1-3), distillation (`distill`) and the non-SR tasks
(`tasks`).

The package exports the functions `train` and `finetune`, which hide the
submodules of the same names as attributes of the package: import those
modules with `importlib.import_module("mulut_tpu_torch.pipelines.train")`
(or `from mulut_tpu_torch.pipelines.train import ...`)."""

from .evaluate import LutEvaluator
from .finetune import finetune
from .train import cosine_lr, make_optimizer, make_train_step, train
from .transfer import cache_lut, lut_grid, transfer_to_luts

__all__ = [
    "LutEvaluator",
    "finetune",
    "cosine_lr",
    "make_optimizer",
    "make_train_step",
    "train",
    "cache_lut",
    "lut_grid",
    "transfer_to_luts",
]

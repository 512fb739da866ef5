"""Entry points: evaluation (step 4), training, LUT transfer and LUT
fine-tuning (steps 1-3), distillation (`distill`), the non-SR tasks
(`tasks`) and the step runner (`orchestrator`).

The package exports the functions `train` and `finetune`, which hide the
submodules of the same names as attributes of the package: import those
modules with `importlib.import_module("mulut_tpu_torch.pipelines.train")`
(or `from mulut_tpu_torch.pipelines.train import ...`)."""

from .evaluate import LutEvaluator, eval_dataset, process_single_image, run_test
from .finetune import finetune
from .train import cosine_lr, make_optimizer, make_train_step, train
from .transfer import cache_lut, lut_grid, transfer_to_luts

__all__ = [
    "LutEvaluator",
    "eval_dataset",
    "process_single_image",
    "run_test",
    "finetune",
    "cosine_lr",
    "make_optimizer",
    "make_train_step",
    "train",
    "cache_lut",
    "lut_grid",
    "transfer_to_luts",
]

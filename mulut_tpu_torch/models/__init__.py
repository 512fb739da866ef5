"""SRNets tap-MLP models, their fast stacks, weight import and
checkpoints, and the LUT-as-model of fine-tuning; the x1 (DNNets) and
demosaic (DMNet) models of the non-SR tasks."""

from .blocks import (
    apply_mulut_c_unit,
    apply_mulut_unit,
    init_mulut_c_unit,
    init_mulut_unit,
)
from .srnet import (
    dmnet_apply,
    dnnet_apply,
    dnnets_predict,
    init_dmnet,
    init_dnnets,
    init_srnets,
    srnet_apply,
    srnets_predict,
    srnets_predict_fast,
    srnets_predict_tiled,
    stack_srnets_for_fast,
    unit_upscale,
)
from .torch_import import (
    load_params_npz,
    load_torch_state_dict,
    save_params_npz,
    srnets_params_from_torch,
)

__all__ = [
    "apply_mulut_c_unit",
    "apply_mulut_unit",
    "init_mulut_c_unit",
    "init_mulut_unit",
    "dmnet_apply",
    "dnnet_apply",
    "dnnets_predict",
    "init_dmnet",
    "init_dnnets",
    "init_srnets",
    "srnet_apply",
    "srnets_predict",
    "srnets_predict_fast",
    "srnets_predict_tiled",
    "stack_srnets_for_fast",
    "unit_upscale",
    "load_params_npz",
    "load_torch_state_dict",
    "save_params_npz",
    "srnets_params_from_torch",
]

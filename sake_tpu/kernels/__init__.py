"""The functional (pytree-parameterized) SAKE model and its linen adapter."""

from sake_tpu.kernels.functional import (
    ModelParams,
    LayerParams,
    CFConvParams,
    init_model_params,
    model_forward,
    energy_and_forces_fn,
)
from sake_tpu.kernels.adapter import (
    model_params_from_linen,
    layer_params_from_linen,
)

__all__ = [
    "ModelParams",
    "LayerParams",
    "CFConvParams",
    "init_model_params",
    "model_forward",
    "energy_and_forces_fn",
    "model_params_from_linen",
    "layer_params_from_linen",
]

from .convert import flax_to_state_dict
from .inference import (
    InferenceModel,
    RandomModel,
    build_inference_model,
    fetch_outputs,
    init_variables,
)
from .nets import GeeseNet, GeisterNet, SimpleConvNet
from .transformer import TransformerNet

__all__ = [
    "GeeseNet",
    "GeisterNet",
    "InferenceModel",
    "RandomModel",
    "SimpleConvNet",
    "TransformerNet",
    "build_inference_model",
    "fetch_outputs",
    "flax_to_state_dict",
    "init_variables",
]

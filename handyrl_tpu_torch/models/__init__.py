from .convert import flax_to_state_dict
from .inference import InferenceModel, RandomModel, init_variables
from .nets import SimpleConvNet
from .transformer import TransformerNet

__all__ = [
    "InferenceModel",
    "RandomModel",
    "SimpleConvNet",
    "TransformerNet",
    "flax_to_state_dict",
    "init_variables",
]

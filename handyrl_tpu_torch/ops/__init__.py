from .flash_attention import masked_attention_reference, masked_flash_attention
from .losses import compute_loss_from_outputs
from .targets import compute_target

__all__ = [
    "compute_loss_from_outputs",
    "compute_target",
    "masked_attention_reference",
    "masked_flash_attention",
]

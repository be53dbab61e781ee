from .flash_attention import flash_attention, masked_attention_reference, masked_flash_attention
from .losses import compute_loss_from_outputs
from .ring_attention import (
    full_attention_reference, masked_ring_attention_shard, masked_ring_self_attention,
    ring_attention_shard, ring_self_attention,
)
from .targets import compute_target

__all__ = [
    "compute_loss_from_outputs",
    "compute_target",
    "flash_attention",
    "full_attention_reference",
    "masked_attention_reference",
    "masked_flash_attention",
    "masked_ring_attention_shard",
    "masked_ring_self_attention",
    "ring_attention_shard",
    "ring_self_attention",
]

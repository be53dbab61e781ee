from .train_step import (
    TrainContext, forward_prediction, live_steps, resolve_seq_attention, resolve_seq_remat,
    trim_burn_in,
)

__all__ = [
    "TrainContext",
    "forward_prediction",
    "live_steps",
    "resolve_seq_attention",
    "resolve_seq_remat",
    "trim_burn_in",
]

from .train_step import TrainContext, forward_prediction, resolve_seq_attention, trim_burn_in

__all__ = ["TrainContext", "forward_prediction", "resolve_seq_attention", "trim_burn_in"]

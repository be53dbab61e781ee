from .batch import make_batch
from .evaluation import evaluate_mp, exec_match
from .generation import Generator, finalize_episode
from .inference_engine import BatchedInferenceEngine, EngineStopped
from .replay import EpisodeStore, compress_block, decompress_block
from .trainer import BatchPipeline, Trainer

__all__ = [
    "BatchPipeline",
    "BatchedInferenceEngine",
    "EngineStopped",
    "EpisodeStore",
    "Generator",
    "Trainer",
    "compress_block",
    "decompress_block",
    "evaluate_mp",
    "exec_match",
    "finalize_episode",
    "make_batch",
]

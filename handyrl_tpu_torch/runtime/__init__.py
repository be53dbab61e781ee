from .batch import make_batch
from .generation import Generator, finalize_episode
from .replay import EpisodeStore, compress_block, decompress_block
from .trainer import Trainer

__all__ = [
    "EpisodeStore",
    "Generator",
    "Trainer",
    "compress_block",
    "decompress_block",
    "finalize_episode",
    "make_batch",
]

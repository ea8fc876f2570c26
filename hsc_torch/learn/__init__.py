"""Dictionary learning — the port's counterpart of `hsc_tpu.learn`: k-means
(`kmeans`), the multilevel trainer (`trainer`), the online learner
(`online`) and npz checkpoints (`checkpoint`)."""

from .checkpoint import DictionaryCheckpointer
from .kmeans import (
    ConvolutionalDictionaryLearner,
    extract_windows,
    kmeans_assign_update,
    kmeans_refine_device,
)
from .online import OnlineConvolutionalDictionaryLearner
from .trainer import MultilevelTrainer

__all__ = [
    "ConvolutionalDictionaryLearner",
    "DictionaryCheckpointer",
    "extract_windows",
    "kmeans_assign_update",
    "kmeans_refine_device",
    "MultilevelTrainer",
    "OnlineConvolutionalDictionaryLearner",
]

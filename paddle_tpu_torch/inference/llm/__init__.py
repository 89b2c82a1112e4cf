"""LLM serving on the paged KV cache, PyTorch/CUDA port.

Mirrors ``paddle_tpu.inference.llm``: ``GenerationEngine(TorchLM)`` ->
``submit`` / ``step`` / ``run`` / ``generate`` / ``output_of``, over a
``ContinuousBatchingScheduler`` and a ``PagedKVCache``, with one unified
ragged step per engine step and n-gram speculative decoding
(``ngram_draft``).
"""
from .engine import GREEDY, GenerationEngine, SamplingParams, ngram_draft
from .kv_cache import CacheConfig, PagedKVCache
from .model import ModelSpec, TorchLM
from .scheduler import (ContinuousBatchingScheduler, InvalidRequest,
                        QueueFull, SchedulerConfig)

__all__ = ["GenerationEngine", "SamplingParams", "GREEDY", "CacheConfig",
           "PagedKVCache", "ModelSpec", "TorchLM",
           "ContinuousBatchingScheduler", "SchedulerConfig", "QueueFull",
           "InvalidRequest", "ngram_draft"]

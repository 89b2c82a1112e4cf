"""LLM serving on the paged KV cache, PyTorch/CUDA port.

Mirrors ``paddle_tpu.inference.llm``: ``GenerationEngine(TorchLM)`` ->
``submit`` / ``step`` / ``run`` / ``generate`` / ``output_of``, over a
``ContinuousBatchingScheduler`` and a ``PagedKVCache``, with one unified
ragged step per engine step and n-gram speculative decoding
(``ngram_draft``); the resilience layer: the request journal
(``RequestJournal``, ``engine.drain`` / ``engine.restore``), fault
injection and the chaos harness (``faults``), the overload brownout
ladder (``Overloaded``) and the device-fault quarantine; and the
replicated serving fabric (``ServingFabric``: N replicas behind a
prefix-affinity router, kill relocation, prefill/decode
disaggregation).
"""
from .brownout import BrownoutConfig, BrownoutController
from .engine import GREEDY, GenerationEngine, SamplingParams, ngram_draft
from .fabric import ROUTE_REASONS, FabricConfig, ServingFabric
from .faults import (DeviceLost, EngineKilled, FaultConfig, FaultInjector,
                     default_injector, run_chaos, set_default_injector)
from .journal import JournalEntry, RequestJournal, read_journal
from .kv_cache import CacheConfig, PagedKVCache
from .model import ModelSpec, TorchLM
from .quant import QuantConfig
from .scheduler import (ContinuousBatchingScheduler, InvalidRequest,
                        Overloaded, QueueFull, SchedulerConfig)

__all__ = ["GenerationEngine", "SamplingParams", "GREEDY", "CacheConfig",
           "PagedKVCache", "ModelSpec", "TorchLM",
           "ContinuousBatchingScheduler", "SchedulerConfig", "QueueFull",
           "InvalidRequest", "Overloaded", "ngram_draft",
           "BrownoutConfig", "BrownoutController", "DeviceLost",
           "EngineKilled", "FaultConfig", "FaultInjector",
           "default_injector", "set_default_injector", "run_chaos",
           "JournalEntry", "RequestJournal", "read_journal",
           "FabricConfig", "ServingFabric", "ROUTE_REASONS", "QuantConfig"]

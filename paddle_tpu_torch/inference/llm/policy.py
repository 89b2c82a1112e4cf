"""Serving policy defaults the port's engine reads.

The JAX package parses most of these from its native host's header and
keeps the speculative-drafting knobs in its engine module; the port
keeps its own copy of the values instead, so that it reads nothing of
that package. ``tests/test_torch_isolation.py`` pins every constant here
against the JAX package's ``shared_policy()`` (with no ``PD_*``
environment set), and ``tests/test_torch_spec_decode.py`` the drafting
knobs against the JAX engine's, so a drifted copy fails there. The
swap-tier defaults are the JAX cache module's (``SWAP_PAGES_DEFAULT``,
``COLD_DEMOTE_DEFAULT``), pinned there too.
"""
from __future__ import annotations

__all__ = ["MAX_QUEUE", "DEFAULT_CHUNK_TOKENS", "STEP_TOKEN_BUDGET",
           "DEFAULT_SPEC_TOKENS", "ASYNC_DEPTH", "KV_QUANT", "WEIGHT_QUANT",
           "KV_QUANT_MODES", "WEIGHT_QUANT_MODES", "KV_SPLIT_PAGES",
           "SPEC_NGRAM_MAX", "SPEC_NGRAM_MIN", "SPEC_WINDOW",
           "SPEC_PROBE_EVERY", "SPEC_DECAY_BELOW", "SPEC_GROW_ABOVE",
           "PRIORITY_CLASSES", "TENANT_MAX_PAGES", "TENANT_MAX_SLOTS",
           "SWAP_PAGES_DEFAULT", "COLD_DEMOTE_DEFAULT",
           "STEPPROF_SAMPLE_PCT", "BROWNOUT_LEVELS", "JOURNAL_SYNC_EVERY",
           "JOURNAL_MAX_BYTES", "WEIGHT_MATMUL", "WEIGHT_MATMUL_MODES",
           "FABRIC_REPLICAS", "FABRIC_SPILL", "FABRIC_ROLES",
           "FABRIC_ROLES_MODES", "SLO_TTFT_MS", "SLO_ITL_MS"]

MAX_QUEUE = 1024             # admission ceiling (waiting-queue depth)
DEFAULT_CHUNK_TOKENS = 0     # chunked-prefill token budget (0 = off)
STEP_TOKEN_BUDGET = 0        # ragged tokens packed per mixed step (0 = off)
DEFAULT_SPEC_TOKENS = 0      # speculative-decode draft budget (0 = off)
ASYNC_DEPTH = 0              # dispatched-ahead steps (0 = serial commit)
KV_QUANT = "off"             # KV-page storage mode
WEIGHT_QUANT = "off"         # serving weight storage mode
KV_QUANT_MODES = ("off", "int8", "fp8")
WEIGHT_QUANT_MODES = ("off", "int8")
KV_SPLIT_PAGES = 0           # flash-decode KV-split chunk width (0 = off)
# the int8 x int8 weight matmul (int32 sums, one epilogue rescale); only
# meaningful with int8 weights, the engine degrades it to off otherwise
WEIGHT_MATMUL = "off"
WEIGHT_MATMUL_MODES = ("off", "int8")

# the replicated serving fabric: replicas behind the prefix-affinity
# router, the queue gap past which an affinity claim spills to the
# least-loaded replica (0 = never), and the topology (a typo'd roles
# string degrades to colocated: there is no fabric-off mode)
FABRIC_REPLICAS = 2
FABRIC_SPILL = 4
FABRIC_ROLES = "colocated"
FABRIC_ROLES_MODES = ("colocated", "disaggregated")

# SLO burn-rate alerting objectives in milliseconds (0 = that objective
# off; both 0 = the evaluator is inert)
SLO_TTFT_MS = 0
SLO_ITL_MS = 0

# multi-tenant admission: priority classes (0 = most urgent) and the
# per-tenant quotas over running requests (0 = unlimited)
PRIORITY_CLASSES = 3
TENANT_MAX_PAGES = 0
TENANT_MAX_SLOTS = 0

# observability and robustness: the share of engine steps the step
# profiler samples (percent), the overload brownout ladder's depth (0 =
# controller off), and the request journal's fsync cadence (records
# between syncs) and compaction bound (bytes)
STEPPROF_SAMPLE_PCT = 6
BROWNOUT_LEVELS = 0
JOURNAL_SYNC_EVERY = 64
JOURNAL_MAX_BYTES = 1048576

# the host swap tier: pages the host store holds (0 = swapping off; a
# preempted request then re-prefills), and whether evicting a parked
# prefix page spills its bytes there first (cold-prefix demotion)
SWAP_PAGES_DEFAULT = 256
COLD_DEMOTE_DEFAULT = True

# n-gram (prompt-lookup) drafting. Any draft is safe (verification emits
# exactly the target-sampled tokens), so these only tune how often
# speculation pays.
SPEC_NGRAM_MAX = 3           # longest context suffix the drafter matches
SPEC_NGRAM_MIN = 2           # shortest suffix worth trusting
SPEC_WINDOW = 8              # verify events in the acceptance window
SPEC_PROBE_EVERY = 16        # draftless steps before a spec_len 0 re-probe
SPEC_DECAY_BELOW = 0.3       # window acceptance below -> shrink spec_len
SPEC_GROW_ABOVE = 0.7        # window acceptance at or above -> grow it

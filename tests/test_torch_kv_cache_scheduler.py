"""The port's paged cache and scheduler against the JAX reference.

Host logic only: both sides run the same scripted sequence and must
agree exactly — prefix block digests, page accounting (allocate,
prefix hits, release, eviction), and the sequence of mixed-step plans
over submits, chunked prefill, decode tokens, EOS and cancels.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from paddle_tpu.inference.llm.kv_cache import (  # noqa: E402
    CacheConfig as JaxCacheConfig, PagedKVCache as JaxCache)
from paddle_tpu.inference.llm.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler as JaxScheduler,
    SchedulerConfig as JaxSchedulerConfig)
from paddle_tpu_torch.inference.llm.kv_cache import (  # noqa: E402
    CacheConfig, PagedKVCache)
from paddle_tpu_torch.inference.llm.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler, InvalidRequest, QueueFull, SchedulerConfig)
from _torch_threads import one_thread  # noqa: E402,F401

GEOM = dict(num_layers=1, num_heads=2, head_dim=4, page_size=4,
            max_slots=4, max_seq_len=64, prefix_cache=True, swap_pages=0,
            demote_cold_prefix=False)


def _caches(num_pages=24):
    return (JaxCache(JaxCacheConfig(num_pages=num_pages, **GEOM)),
            PagedKVCache(CacheConfig(num_pages=num_pages, **GEOM),
                         device="cpu"))


def _state(cache):
    return (sorted(cache._free), list(cache._evictable),
            {s: list(p) for s, p in cache._allocated_pages.items()},
            cache.num_free_pages, cache.num_cached_pages, cache.pages_in_use,
            cache.prefix_hits, cache.prefix_evictions,
            [cache.prefix_len(s) for s in range(GEOM["max_slots"])],
            np.asarray(cache.page_table).tolist())


@pytest.mark.parametrize("seed", range(3))
def test_block_hashes_equal(seed):
    j, t = _caches()
    rng = np.random.default_rng(seed)
    for n in (0, 3, 4, 17, 40):
        prompt = rng.integers(0, 50000, size=n).tolist()
        assert t._block_hashes(prompt) == j._block_hashes(prompt)


def test_page_accounting_equal_over_a_script():
    """allocate (with prefix hits), commit_prefix, release, LRU parking
    and eviction under pressure — identical state after every op."""
    j, t = _caches(num_pages=14)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 1000, size=12).tolist()
    prompts = {0: shared + [1, 2, 3], 1: shared + [9], 2: list(range(20)),
               3: list(range(50, 67))}
    script = [("alloc", 0, 24), ("commit", 0), ("alloc", 1, 16),
              ("commit", 1), ("release", 0), ("alloc", 2, 30),
              ("release", 1), ("alloc", 3, 16), ("commit", 3),
              ("release", 2), ("alloc", 0, 40), ("release", 3),
              ("release", 0), ("alloc", 1, 44)]
    for op in script:
        ok = {}
        for name, cache in (("jax", j), ("torch", t)):
            if op[0] == "alloc":
                ok[name] = cache.allocate(op[1], op[2], prompt=prompts[op[1]])
            elif op[0] == "commit":
                cache.commit_prefix(op[1], prompts[op[1]])
            elif cache._allocated_pages[op[1]]:
                cache.release(op[1])
            cache.check_invariants()
        if op[0] == "alloc":
            assert ok["torch"] == ok["jax"], op
            assert j.can_allocate(8) == t.can_allocate(8)
        assert _state(t) == _state(j), op
    assert t.prefix_hits > 0 and t.prefix_evictions > 0


def test_release_refuses_a_double_free():
    _, t = _caches()
    assert t.allocate(0, 10)
    t.release(0)
    with pytest.raises(RuntimeError, match="double free"):
        t.release(0)


def _drive(sched, cache, rng, script, eos_id):
    """Run ``script`` (step index -> actions) over ``sched`` and return
    the plan of every step as plain tuples, keyed by submission order."""
    order = {}
    plans = []
    for step in range(60):
        for action in script.get(step, ()):
            if action[0] == "submit":
                rid = sched.submit(action[1], action[2])
                order[rid] = len(order)
            else:
                sched.cancel(next(r for r, i in order.items()
                                  if i == action[1]))
        plan = sched.step_plan()
        plans.append((plan.kind, [
            (r.kind, order[r.request.rid], r.request.slot, r.start,
             r.chunk_len, r.first_chunk, r.final_chunk) for r in plan.rows]))
        emitted = {}
        for r in plan.rows:
            req = r.request
            if r.kind == "chunk":
                tok = int(rng[order[req.rid]].integers(1, 50))
                sched.on_chunk_done(req, r, tok if r.final_chunk else None,
                                    eos_id)
            else:
                cache.seq_lens[req.slot] += 1
                emitted[req.slot] = int(rng[order[req.rid]].integers(0, 12))
        sched.on_verify_done({s: [t] for s, t in emitted.items()}, eos_id)
        cache.check_invariants()
        if plan.kind == "idle" and step > max(script):
            break
    outputs = {order[r]: (list(req.output), req.finish_reason)
               for r, req in sched.requests.items()}
    return plans, outputs


@pytest.mark.parametrize("chunk_tokens,budget", [(0, 0), (6, 0), (0, 10),
                                                 (8, 5)])
def test_plan_sequence_equal(chunk_tokens, budget):
    shared = list(range(100, 120))
    script = {0: [("submit", shared + [1, 2, 3], 6),
                  ("submit", list(range(30)), 8)],
              1: [("submit", shared + [7] * 9, 5),
                  ("submit", [5, 6, 7], 12)],
              3: [("submit", list(range(40, 57)), 4)],
              5: [("cancel", 3)],
              6: [("submit", shared + [9], 7),
                  ("submit", list(range(7)), 30)],
              9: [("cancel", 5)]}
    results = []
    for is_jax in (True, False):
        j_cache, t_cache = _caches(num_pages=26)
        if is_jax:
            cache = j_cache
            sched = JaxScheduler(cache, JaxSchedulerConfig(
                max_slots=4, max_seq_len=64, chunk_tokens=chunk_tokens,
                step_token_budget=budget))
        else:
            cache = t_cache
            sched = ContinuousBatchingScheduler(cache, SchedulerConfig(
                max_slots=4, max_seq_len=64, chunk_tokens=chunk_tokens,
                step_token_budget=budget))
        rng = [np.random.default_rng(i) for i in range(16)]
        results.append(_drive(sched, cache, rng, script, eos_id=3))
    (jp, jo), (tp, to) = results
    assert tp == jp
    assert to == jo
    assert any(reason == "eos" for _, reason in to.values())
    assert any(reason == "cancelled" for _, reason in to.values())


def test_ragged_buckets_and_step_bound_equal():
    for kw in ({}, dict(chunk_tokens=24), dict(step_token_budget=40),
               dict(max_seq_len=1024, max_slots=8)):
        j = JaxSchedulerConfig(**kw)
        t = SchedulerConfig(**kw)
        assert t.step_buckets() == j.step_buckets()
        assert t.max_step_tokens() == j.max_step_tokens()


def test_submit_validation():
    _, cache = _caches()
    sched = ContinuousBatchingScheduler(cache, SchedulerConfig(
        max_slots=4, max_seq_len=64, max_queue=2))
    with pytest.raises(InvalidRequest):
        sched.submit([], 4)
    with pytest.raises(InvalidRequest):
        sched.submit([1], 0)
    with pytest.raises(InvalidRequest):
        sched.submit([1] * 60, 10)
    sched.submit([1], 2)
    sched.submit([2], 2)
    with pytest.raises(QueueFull):
        sched.submit([3], 2)


@pytest.mark.parametrize("knob", ["async_depth", "tenant_max_pages",
                                  "tenant_max_slots", "brownout_levels"])
def test_later_slice_knobs_raise(knob):
    """Async depth, the tenant quotas (the async and multi-tenant slice)
    and the brownout ladder (the robustness slice) are accepted, alone
    and beside each other; the quantized collectives, a later slice,
    still raise beside any of them."""
    assert getattr(SchedulerConfig(**{knob: 1}), knob) == 1
    cfg = SchedulerConfig(**{knob: 1, "brownout_levels": 4})
    assert (getattr(cfg, knob), cfg.brownout_levels) == (
        4 if knob == "brownout_levels" else 1, 4)
    with pytest.raises(NotImplementedError, match="slice"):
        SchedulerConfig(**{knob: 1, "coll_quant": "int8"})


def test_later_slice_submit_args_and_cache_knobs_raise():
    """Priorities, deadlines, the swap tier and cold-prefix demotion are
    ported (the JAX package's defaults included); the quantized
    collectives and the int8 matmul still raise."""
    _, cache = _caches()
    sched = ContinuousBatchingScheduler(cache, SchedulerConfig(
        max_slots=4, max_seq_len=64))
    rid = sched.submit([1, 2], 2, priority=1, tenant="t", deadline_s=1.0)
    req = sched.requests[rid]
    assert (req.priority, req.tenant, req.deadline_s) == (1, "t", 1.0)
    with pytest.raises(InvalidRequest):
        sched.submit([1, 2], 2, priority=SchedulerConfig().priority_classes)
    cfg = CacheConfig(num_layers=1, num_heads=1, head_dim=4)
    jcfg = JaxCacheConfig(num_layers=1, num_heads=1, head_dim=4)
    assert (cfg.swap_pages, cfg.demote_cold_prefix) == \
        (jcfg.swap_pages, jcfg.demote_cold_prefix)
    for kw in (dict(coll_quant="int8"), dict(weight_matmul="int8")):
        with pytest.raises(NotImplementedError, match="slice"):
            CacheConfig(num_layers=1, num_heads=1, head_dim=4, **kw)

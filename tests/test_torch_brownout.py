"""The port's overload brownout controller (``inference/llm/brownout.py``)
against the JAX package's, on the CPU.

- Scripted pressure: both controllers over their own scheduler and
  page pool, driven by the same sequence of submits, cancels and page
  allocations, walk the same ladder: equal levels, transitions, sheds,
  retry-after hints (exact: with no admission the hint is the queue
  term) and the same scheduler and cache state at every tick (budget
  override, speculation suspended, prefix admission paused, shed floor).
- On the engines: under overload (a small queue, three priority
  classes) the JAX engine and the port climb and descend the same
  ladder, shed the same requests, and serve the others the same tokens;
  every shed request and every ``Overloaded`` rejection carries a
  retry-after above 0.
- The actions one by one: level 2 suspends speculation (tokens
  unchanged, no drafts), level 3 pauses prefix-cache admission, level 4
  rejects the lowest class with ``Overloaded`` (a ``QueueFull``) and
  sheds queued work; a config with ``brownout_levels=0`` is inert.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu import observability as jobs  # noqa: E402
from paddle_tpu.inference.llm import CacheConfig as JaxCacheConfig  # noqa: E402
from paddle_tpu.inference.llm import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu.inference.llm import JaxLM, PagedKVCache as JaxCache  # noqa: E402
from paddle_tpu.inference.llm import (  # noqa: E402
    SchedulerConfig as JaxSchedulerConfig)
from paddle_tpu.inference.llm import brownout as jb  # noqa: E402
from paddle_tpu.inference.llm import scheduler as jsched  # noqa: E402
from paddle_tpu_torch import observability as tobs  # noqa: E402
from paddle_tpu_torch.inference.llm import (  # noqa: E402
    CacheConfig, GenerationEngine, PagedKVCache, QueueFull, SchedulerConfig,
    TorchLM)
from paddle_tpu_torch.inference.llm import brownout as tb  # noqa: E402
from paddle_tpu_torch.inference.llm import scheduler as tsched  # noqa: E402
from paddle_tpu_torch.inference.llm.model import params_from_jax  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

VOCAB = 64


@pytest.fixture(scope="module")
def models():
    jm = JaxLM.tiny(vocab=VOCAB, d_model=32, num_layers=2, num_heads=2,
                    head_dim=16, max_seq_len=128, seed=7)
    np_params = {k: np.asarray(v) for k, v in jm.params.items()}
    return jm, TorchLM(jm.spec, params_from_jax(np_params, "cpu"),
                       device="cpu")


def _geom(num_pages=33):
    return dict(num_layers=1, num_heads=1, head_dim=4, max_slots=4,
                num_pages=num_pages, max_seq_len=128)


def _controller(side, cfg=None):
    """A controller over a fresh scheduler, cache and SLO digest (the
    retry-after hint reads the digest; the process default holds what
    earlier engines observed)."""
    sched_cfg = dict(max_slots=4, max_seq_len=128, max_queue=16,
                     brownout_levels=4)
    obs = jobs if side == "jax" else tobs
    prev = obs.set_default_slo_digest(obs.SLODigest())
    try:
        if side == "jax":
            cache = JaxCache(JaxCacheConfig(**_geom()))
            sch = jsched.ContinuousBatchingScheduler(
                cache, JaxSchedulerConfig(**sched_cfg))
            mod = jb
        else:
            cache = PagedKVCache(CacheConfig(**_geom()), device="cpu")
            sch = tsched.ContinuousBatchingScheduler(
                cache, SchedulerConfig(**sched_cfg))
            mod = tb
    finally:
        obs.set_default_slo_digest(prev)
    eng = types.SimpleNamespace(scheduler=sch, cache=cache)
    return mod.BrownoutController(eng, cfg), sch, cache


def _state(ctl, sch, cache):
    return (ctl.level, ctl.transitions, ctl.sheds, sch.step_budget_override,
            sch.spec_suspended, cache.prefix_admission_paused,
            sch.shed_floor, round(sch.overload_retry_after_s, 12),
            sch.stats["n_shed"], sch.stats["n_overload_rejected"],
            sch.num_waiting)


def _script(seed):
    """Per tick: (submits as priorities, cancels, +1 to fill the pool
    with four whole-context slots / -1 to release them)."""
    rng = np.random.default_rng(seed)
    plan = []
    for t in range(400):
        if t < 100:                       # overload: arrivals outpace
            subs = [int(rng.integers(0, 3)) for _ in range(3)]
            plan.append((subs, 0, 0))
        elif t < 120:                     # page pressure, queue drains
            plan.append(([], 4, 1 if t == 100 else 0))
        else:                             # calm: pages come back
            plan.append(([], 2, -1 if t == 120 else 0))
    return plan


@pytest.mark.parametrize("seed", [0, 1])
def test_scripted_pressure_walks_the_same_ladder(seed):
    sides = {s: _controller(s) for s in ("jax", "torch")}
    trace = {s: [] for s in sides}
    for subs, cancels, pages in _script(seed):
        for side, (ctl, sch, cache) in sides.items():
            for pr in subs:
                try:
                    sch.submit([1, 2, 3, 4], 4, priority=pr)
                except (QueueFull, jsched.QueueFull) as e:   # Overloaded too
                    trace[side].append(("reject", type(e).__name__,
                                        round(getattr(e, "retry_after_s",
                                                      0.0), 12)))
            for _ in range(cancels):
                if sch.waiting:
                    sch.cancel(sch.waiting[-1].rid)
            for slot in range(4):
                if pages > 0:
                    assert cache.allocate(slot, 128)
                elif pages < 0:
                    cache.release(slot)
            ctl.tick()
            trace[side].append(_state(ctl, sch, cache))
    assert trace["torch"] == trace["jax"]
    levels = [t[0] for t in trace["torch"] if t[0] != "reject"]
    assert max(levels) == 4 and levels[-1] == 0
    assert any(t[0] == "reject" and t[1] == "Overloaded"
               for t in trace["torch"])
    assert all(t[2] > 0 for t in trace["torch"]
               if t[0] == "reject" and t[1] == "Overloaded")


def test_retry_after_reads_the_queue_wait_digest():
    ctl, sch, _ = _controller("torch")
    assert ctl.retry_after_s() == ctl.config.min_retry_after_s
    for i in range(12):
        sch._slo.observe("queue_wait", "t", 1, 0.5 + 0.01 * i)
    assert ctl.retry_after_s() == pytest.approx(
        sch._slo.quantile("queue_wait", "t", 1, 0.5))
    jctl, jsch, _ = _controller("jax")
    for i in range(12):
        jsch._slo.observe("queue_wait", "t", 1, 0.5 + 0.01 * i)
    assert ctl.retry_after_s() == jctl.retry_after_s()


def _serve_overloaded(eng, prompts, arrivals):
    levels, rejected = [], []
    rids = []
    for t in range(len(arrivals)):
        for i in arrivals[t]:
            try:
                rids.append(eng.submit(prompts[i], 6, priority=i % 3))
            except (QueueFull, jsched.QueueFull) as e:
                rejected.append((type(e).__name__,
                                 getattr(e, "retry_after_s", None)))
        eng.step()
        levels.append(eng.brownout.level)
    for _ in range(600):
        if not (eng.scheduler.has_work or eng.pipeline_depth
                or eng.brownout.level):
            break
        eng.step()
        levels.append(eng.brownout.level)
    return rids, levels, rejected


@pytest.mark.parametrize("depth", [0, 1])
def test_engines_shed_the_same_requests(models, depth):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, VOCAB, size=int(rng.integers(4, 20))).tolist()
               for _ in range(240)]
    arrivals = [[3 * t + k for k in range(3)] for t in range(80)]
    sched = dict(max_slots=2, max_seq_len=128, chunk_tokens=8,
                 max_queue=8, brownout_levels=4, async_depth=depth)
    geom = dict(num_layers=2, num_heads=2, head_dim=16, max_slots=2,
                num_pages=64, max_seq_len=128)
    je = JaxEngine(models[0], cache_config=JaxCacheConfig(**geom),
                   scheduler_config=JaxSchedulerConfig(**sched))
    je.stepprof.disable()
    te = GenerationEngine(models[1], cache_config=CacheConfig(**geom),
                          scheduler_config=SchedulerConfig(**sched),
                          device="cpu")
    jr, jl, jrej = _serve_overloaded(je, prompts, arrivals)
    tr, tl, trej = _serve_overloaded(te, prompts, arrivals)
    assert tl == jl and max(tl) == 4 and tl[-1] == 0
    assert [k for k, _ in trej] == [k for k, _ in jrej]
    assert all(v > 0 for k, v in trej if k == "Overloaded")
    treqs = [te.scheduler.requests[r] for r in tr]
    jreqs = [je.scheduler.requests[r] for r in jr]
    assert [r.finish_reason for r in treqs] == \
        [r.finish_reason for r in jreqs]
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    shed = [r for r in treqs if r.finish_reason == "shed"]
    assert shed and all(r.retry_after_s > 0 for r in shed)
    assert te.scheduler.stats["n_shed"] == je.scheduler.stats["n_shed"]
    assert te.brownout.transitions == je.brownout.transitions
    te.cache.check_invariants()
    assert te.cache.pages_in_use == 0


def test_level_two_suspends_speculation(models):
    rng = np.random.default_rng(5)
    motif = rng.integers(0, VOCAB, size=6).tolist()
    prompts = [motif * 4 for _ in range(3)]
    outs = {}
    for lvl in (0, 2):
        eng = GenerationEngine(
            models[1], cache_config=CacheConfig(
                num_layers=2, num_heads=2, head_dim=16, max_slots=3,
                num_pages=64, max_seq_len=128),
            scheduler_config=SchedulerConfig(
                max_slots=3, max_seq_len=128, spec_tokens=3,
                brownout_levels=4), device="cpu")
        eng.brownout.config = tb.BrownoutConfig(levels=4, eval_every=10**9)
        if lvl:
            eng.brownout._transition(1, 0.0, 0.0)
            eng.brownout._transition(2, 0.0, 0.0)
            assert eng.scheduler.spec_suspended
            assert eng.scheduler.step_budget_override is not None
        outs[lvl] = eng.generate(prompts, 10)
        drafted = eng.scheduler.stats["n_spec_drafted"]
        assert (drafted == 0) == bool(lvl)
    assert outs[0] == outs[2]


def test_level_three_pauses_prefix_admission_and_four_sheds():
    ctl, sch, cache = _controller("torch")
    for lvl in (1, 2, 3):
        ctl._transition(lvl, 0.0, 0.0)
    assert cache.prefix_admission_paused and sch.shed_floor is None
    assert cache.allocate(1, 32, prompt=list(range(32)))
    assert cache.commit_prefix(1, list(range(32))) == 0   # not admitted
    for _ in range(6):
        sch.submit([1, 2], 2, priority=2)
    ctl._transition(4, 0.0, 0.0)
    assert sch.shed_floor == 2
    with pytest.raises(tsched.Overloaded) as e:
        sch.submit([1, 2], 2, priority=2)
    assert isinstance(e.value, QueueFull) and e.value.retry_after_s > 0
    sch.submit([1, 2], 2, priority=0)                     # still admitted
    ctl.tick()                                            # sheds at 4
    assert ctl.sheds == 6 and sch.num_waiting == 1
    assert all(r.retry_after_s > 0 for r in sch.finished.values())
    for lvl in (3, 2, 1, 0):
        ctl._transition(lvl, 0.0, 0.0)
    assert (sch.shed_floor, sch.spec_suspended, cache.prefix_admission_paused,
            sch.step_budget_override) == (None, False, False, None)


def test_brownout_off_is_inert():
    cache = PagedKVCache(CacheConfig(**_geom()), device="cpu")
    sch = tsched.ContinuousBatchingScheduler(
        cache, SchedulerConfig(max_slots=4, max_seq_len=128, max_queue=4))
    ctl = tb.BrownoutController(types.SimpleNamespace(scheduler=sch,
                                                      cache=cache))
    for _ in range(4):
        sch.submit([1], 1, priority=2)
    for _ in range(100):
        assert ctl.tick() == 0
    assert not ctl.enabled and ctl.transitions == 0

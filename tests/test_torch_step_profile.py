"""The port's step-phase profiler (``observability/stepprof.py``)
against the JAX package's, on the CPU.

- The phase set is the JAX profiler's; the port's engine leaves one
  record per ``step()`` call, each committing at most one step at depth
  0 and 1 and their commits summing to the steps committed; a record's
  phases sum to within 5 % of its wall time (the laps telescope; the
  bound the chip smoke holds the card to).
- Sampling: with ratio r every round(1/r)-th step is in the sample, the
  first one included; the engine reports those steps' device spans.
- Overlap accounting with an injected clock: idle(N) = max(0,
  start(N) - done(N-1)), the host-clock chain the CPU uses and the
  event-timed spans the card reports give the same totals and the same
  idle share; a disabled profiler records nothing and costs one branch
  per call (no clock read).
- Parity: the same request set (three priority classes, a tenant slot
  quota, preemption, a deadline) through the JAX engine and the port,
  both profilers off, ends with equal counters (submitted, finished,
  preemptions, quota deferrals, sheds, device faults) and equal SLO
  digest key sets.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu import observability as jobs  # noqa: E402
from paddle_tpu.inference.llm import CacheConfig as JaxCacheConfig  # noqa: E402
from paddle_tpu.inference.llm import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu.inference.llm import JaxLM  # noqa: E402
from paddle_tpu.inference.llm import (  # noqa: E402
    SchedulerConfig as JaxSchedulerConfig)
from paddle_tpu_torch import observability as tobs  # noqa: E402
from paddle_tpu_torch.inference.llm import (  # noqa: E402
    CacheConfig, GenerationEngine, SchedulerConfig, TorchLM)
from paddle_tpu_torch.inference.llm.model import params_from_jax  # noqa: E402
from paddle_tpu_torch.observability.stepprof import StepProfiler  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

VOCAB = 64


@pytest.fixture(scope="module")
def models():
    jm = JaxLM.tiny(vocab=VOCAB, d_model=32, num_layers=2, num_heads=2,
                    head_dim=16, max_seq_len=128, seed=7)
    np_params = {k: np.asarray(v) for k, v in jm.params.items()}
    return jm, TorchLM(jm.spec, params_from_jax(np_params, "cpu"),
                       device="cpu")


def _geom(max_slots=3, num_pages=64):
    return dict(num_layers=2, num_heads=2, head_dim=16, max_slots=max_slots,
                num_pages=num_pages, max_seq_len=128)


def _port(models, depth=0, **kw):
    cfg = dict(max_slots=3, max_seq_len=128, chunk_tokens=8,
               async_depth=depth)
    cfg.update(kw)
    return GenerationEngine(models[1], cache_config=CacheConfig(**_geom()),
                            scheduler_config=SchedulerConfig(**cfg),
                            device="cpu")


def _prompts(n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=int(rng.integers(4, 30))).tolist()
            for _ in range(n)]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_phase_set_is_the_jax_one():
    assert tobs.PHASES == jobs.PHASES
    assert StepProfiler(registry=tobs.Registry()).summary()["steps"] == 0


@pytest.mark.parametrize("depth", [0, 1])
def test_one_record_per_step_and_phases_sum(models, depth):
    eng = _port(models, depth)
    calls = 0
    for p in _prompts():
        eng.submit(p, 6)
    while eng.scheduler.has_work or eng.pipeline_depth:
        eng.step()
        calls += 1
    recs = eng.stepprof.records()
    assert len(recs) == calls
    assert sum(r.commits for r in recs) == eng.steps_committed
    assert max(r.commits for r in recs) == 1
    for r in recs:
        assert abs(sum(r.phases.values()) - r.dur) <= 0.05 * r.dur
        assert set(r.phases) <= set(tobs.PHASES)
    mixed = [r for r in recs if r.kind == "mixed"]
    assert all({"plan", "pack", "dispatch"} <= set(r.phases) for r in mixed)
    assert sum(r.tokens_out for r in recs) == sum(
        len(q.output) for q in eng.scheduler.requests.values())
    summ = eng.stepprof.summary()
    assert summ["commits"] == eng.steps_committed
    assert summ["gap_steps"] == eng.steps_dispatched - 1
    assert summ["device_busy_steps"] == eng.steps_committed
    assert 0.0 <= summ["idle_share"] <= 1.0


@pytest.mark.parametrize("sample,period", [(0.25, 4), (0.06, 17), (1.0, 1),
                                           (0.0, 0)])
def test_sampled_steps_at_the_configured_ratio(sample, period):
    prof = StepProfiler(registry=tobs.Registry(), sample=sample)
    fenced = []
    for i in range(40):
        prof.begin_step()
        fenced.append(prof.fence)
        if prof.fence:
            prof.device(0.0, 0.001)
        prof.end_step("mixed")
    want = [period > 0 and i % period == 0 for i in range(40)]
    assert fenced == want
    assert prof.fenced_steps == sum(want)
    assert [r.fenced for r in prof.records()] == want


def test_engine_reports_the_sampled_steps(models, monkeypatch):
    monkeypatch.setenv("PD_OBS_STEPPROF_SAMPLE", "0.5")
    eng = _port(models, 0)
    eng.generate(_prompts(3), 4)
    recs = [r for r in eng.stepprof.records() if r.kind == "mixed"]
    assert recs[0].fenced and recs[0].device_s > 0
    assert sum(r.fenced for r in recs) == eng.stepprof.fenced_steps > 1


def test_overlap_accounting_with_an_injected_clock():
    """Depth 1 on a host clock: step N is enqueued before N-1 is done
    (gap 0) except after a host stall; the chain's totals and idle
    share, and the same spans reported event-timed, agree."""
    spans = [(0.0, 1.0), (0.5, 2.0), (1.5, 3.0), (4.0, 5.0), (4.5, 6.0)]
    a = StepProfiler(registry=tobs.Registry())
    b = StepProfiler(registry=tobs.Registry())
    a.set_overlap(True)
    b.set_overlap(True)
    prev = None
    for start, done in spans:
        a.device_gap(start, done, depth=1)
        gap = None if prev is None else max(start - prev, 0.0)
        busy = done - max(start, prev if prev is not None else start)
        b.device_span(gap, busy, depth=1)
        prev = done
    for p in (a, b):
        p.note_tokens(10)
        s = p.summary()
        assert s["gap_steps"] == 4
        assert s["gap_idle_s"] == pytest.approx(1.0)       # 3.0 -> 4.0
        assert s["gap_busy_s"] == pytest.approx(4.0)       # net of queue
        # the device time per step counts the chain's first step too
        assert s["device_busy_s"] == pytest.approx(5.0)
        assert s["device_busy_steps"] == 5
        assert s["idle_share"] == pytest.approx(0.2)
        assert p.device_idle_per_token_s == pytest.approx(0.1)
        assert p.host_overhead_ratio == pytest.approx(0.2)
    assert a.gap_depth_profile()[1]["samples"] == 4.0


def test_phase_attribution_with_an_injected_clock():
    clock = _Clock()
    prof = StepProfiler(registry=tobs.Registry(), sample=0.0)
    prof.clock = clock
    prof.begin_step()
    for phase, dt in (("plan", 0.002), ("pack", 0.001), ("dispatch", 0.004),
                      ("plan", 0.001), ("sample_commit", 0.003)):
        clock.t += dt
        prof.lap(phase)
    clock.t += 0.0005
    prof.end_step("mixed")
    rec = prof.last_record()
    assert rec.phases == pytest.approx({"plan": 0.003, "pack": 0.001,
                                        "dispatch": 0.004,
                                        "sample_commit": 0.003})
    assert rec.dur == pytest.approx(0.0115)


def test_disabled_profiler_costs_one_branch():
    reads = []
    prof = StepProfiler(registry=tobs.Registry(), enabled=False)
    prof.clock = lambda: reads.append(1) or 0.0
    for _ in range(5):
        prof.begin_step()
        prof.lap("plan")
        prof.annotate(tokens=3)
        prof.device(0.0, 1.0)
        prof.device_span(0.1, 1.0)
        prof.device_gap(0.0, 1.0)
        prof.note_tokens(4)
        prof.end_step()
    assert not reads and len(prof) == 0 and not prof.active
    assert prof.summary()["gap_steps"] == 0
    assert prof.summary()["device_busy_steps"] == 0
    reg = tobs.Registry()
    on = StepProfiler(registry=reg)
    reg.disable()                        # obs.disable() quiets it too
    on.begin_step()
    assert not on.active


def test_engine_profiler_off_with_observability_off(models):
    try:
        tobs.disable()
        eng = _port(models, 1)
        eng.generate(_prompts(3), 4)
    finally:
        tobs.enable()
    assert len(eng.stepprof) == 0


def _contended(engine, prompts):
    rids = []
    for i, p in enumerate(prompts):
        rids.append(engine.submit(p, 10, priority=2 - i % 3,
                                  tenant="ab"[i % 2],
                                  deadline_s=(1e-9 if i == 4 else 0.0)))
        engine.step()
    engine.run()
    return rids


@pytest.mark.parametrize("depth", [0, 1])
def test_counters_and_digest_keys_match_jax(models, depth):
    prompts = _prompts(8, seed=11)
    sched = dict(max_slots=2, max_seq_len=128, chunk_tokens=8,
                 async_depth=depth, tenant_max_slots=1)
    out = {}
    for side in ("jax", "torch"):
        digest = (jobs if side == "jax" else tobs).SLODigest()
        mod = jobs if side == "jax" else tobs
        prev = mod.set_default_slo_digest(digest)
        try:
            if side == "jax":
                eng = JaxEngine(models[0],
                                cache_config=JaxCacheConfig(**_geom(2, 24)),
                                scheduler_config=JaxSchedulerConfig(**sched))
                eng.stepprof.disable()
            else:
                eng = GenerationEngine(
                    models[1], cache_config=CacheConfig(**_geom(2, 24)),
                    scheduler_config=SchedulerConfig(**sched), device="cpu")
                eng.stepprof.disable()
        finally:
            mod.set_default_slo_digest(prev)
        rids = _contended(eng, prompts)
        st = eng.scheduler.stats
        out[side] = (
            {k: st[k] for k in ("n_submitted", "n_finished",
                                "n_preemptions", "n_quota_deferred",
                                "n_shed", "n_overload_rejected",
                                "n_device_faults", "n_timeouts")},
            digest.keys(),
            [eng.scheduler.requests[r].output for r in rids])
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][0]["n_quota_deferred"] > 0
    assert out["torch"][0]["n_timeouts"] == 1
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2] == out["jax"][2]

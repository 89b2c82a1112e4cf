"""The port's async pipeline (``SchedulerConfig.async_depth``) against the
JAX package's (``tests/test_async_engine.py``), on the CPU.

Both engines serve the JAX package's tiny model (its weights carried
over with ``params_from_jax``) under the same cache and scheduler
configs: chunked prefill, the prefix cache and ``spec_tokens=3`` on.

- Mirror: the port at depth 1 gives the JAX engine's depth-1 tokens and
  finish reasons, greedy and sampled, with an EOS, and the same
  pipeline counters (steps dispatched and committed, rollbacks, the
  occupancy histogram, the speculation totals).
- Bit-exact inside the port: depths 0, 1 and 2 give the same tokens,
  greedy and sampled, with speculation, an EOS mid-stream, preemptions,
  int8 and fp8 pages and the KV split set.
- Rollback: a request cancelled, timed out or finished while it has
  rows in flight has them dead-marked; the pool ends exactly restored.
- Compile bound and mirror: the step signatures stay within
  ``graph_bound``, the page-table copy is uploaded only when the host
  table changed, and every step samples the padded row count.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.inference.llm import CacheConfig as JaxCacheConfig  # noqa: E402
from paddle_tpu.inference.llm import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu.inference.llm import JaxLM  # noqa: E402
from paddle_tpu.inference.llm import SamplingParams as JaxSP  # noqa: E402
from paddle_tpu.inference.llm import (  # noqa: E402
    SchedulerConfig as JaxSchedulerConfig)
from paddle_tpu_torch.inference.llm import (  # noqa: E402
    CacheConfig, GenerationEngine, QueueFull, SamplingParams,
    SchedulerConfig, TorchLM, policy)
from paddle_tpu_torch.inference.llm import engine as tengine  # noqa: E402
from paddle_tpu_torch.inference.llm.model import params_from_jax  # noqa: E402
from paddle_tpu_torch.inference.llm.quant import QuantConfig  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

VOCAB = 64
SAMPLED = (0.85, 8, 0.9, 42)
DEPTHS = [1, 2]


@pytest.fixture(scope="module")
def models():
    jm = JaxLM.tiny(vocab=VOCAB, d_model=32, num_layers=2, num_heads=2,
                    head_dim=16, max_seq_len=128, seed=7)
    np_params = {k: np.asarray(v) for k, v in jm.params.items()}
    return jm, TorchLM(jm.spec, params_from_jax(np_params, "cpu"),
                       device="cpu")


def _geom(max_slots=3, num_pages=64, prefix=True):
    return dict(num_layers=2, num_heads=2, head_dim=16, max_slots=max_slots,
                num_pages=num_pages, max_seq_len=128, prefix_cache=prefix)


def _sched(depth, **kw):
    cfg = dict(max_slots=3, min_bucket=16, max_seq_len=128,
               chunk_tokens=8, spec_tokens=3, async_depth=depth)
    cfg.update(kw)
    return cfg


def _engine(models, depth, eos_id=None, quant=None, **kw):
    cfg = _sched(depth, **kw)
    return GenerationEngine(
        models[1], cache_config=CacheConfig(**_geom(cfg["max_slots"])),
        scheduler_config=SchedulerConfig(**cfg), eos_id=eos_id,
        quant=quant, device="cpu")


def _jax_engine(models, depth, eos_id=None, **kw):
    """The JAX engine with its step profiler off: the profiler's fenced
    samples drain the pipeline, a behavior of the observability layer
    the port has not taken yet, which would shift the step counts."""
    cfg = _sched(depth, **kw)
    eng = JaxEngine(
        models[0], cache_config=JaxCacheConfig(**_geom(cfg["max_slots"])),
        scheduler_config=JaxSchedulerConfig(**cfg), eos_id=eos_id)
    eng.stepprof.disable()
    return eng


def _workload(n=8, seed=7):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, VOCAB, size=int(rng.integers(4, 30))).tolist()
               for _ in range(n)]
    mnts = [int(rng.integers(3, 14)) for _ in range(n)]
    return prompts, mnts


def _drive(eng, prompts, mnts, sampling=None):
    rids = []
    for p, m in zip(prompts, mnts):
        while True:
            try:
                rids.append(eng.submit(p, m, sampling))
                break
            except QueueFull:
                eng.step()
    eng.run()
    return rids, [eng.output_of(r) for r in rids]


def _sp(side, sampling):
    if sampling is None:
        return None
    return (JaxSP if side == "jax" else SamplingParams)(*sampling)


def _assert_restored(eng):
    assert eng.pipeline_depth == 0
    assert eng.cache.num_free_pages == eng.cache.config.num_pages - 1
    eng.cache.check_invariants()


def _eos_of(base):
    """A token that ends some request mid-stream."""
    return collections.Counter(
        t for o in base for t in o[:-1]).most_common(1)[0][0]


# ---------------------------------------------------------- mirror --


class TestMatchesJax:
    @pytest.mark.parametrize("sampling", [None, SAMPLED],
                             ids=["greedy", "sampled"])
    def test_depth1_tokens_and_reasons_match(self, models, sampling):
        prompts, mnts = _workload(seed=11)
        je, te = _jax_engine(models, 1), _engine(models, 1)
        jr, jo = _drive(je, prompts, mnts, _sp("jax", sampling))
        tr, to = _drive(te, prompts, mnts, _sp("torch", sampling))
        assert to == jo
        assert ([te.scheduler.requests[r].finish_reason for r in tr]
                == [je.scheduler.requests[r].finish_reason for r in jr])
        _assert_restored(te)

    def test_depth1_eos_matches(self, models):
        prompts, mnts = _workload(seed=9)
        _, base = _drive(_engine(models, 0), prompts, mnts)
        eos = _eos_of(base)
        je, te = _jax_engine(models, 1, eos), _engine(models, 1, eos)
        jr, jo = _drive(je, prompts, mnts)
        tr, to = _drive(te, prompts, mnts)
        assert to == jo
        assert ([te.scheduler.requests[r].finish_reason for r in tr]
                == [je.scheduler.requests[r].finish_reason for r in jr])
        assert "eos" in {te.scheduler.requests[r].finish_reason for r in tr}
        assert te.async_rollbacks == je.async_rollbacks > 0

    @pytest.mark.parametrize("spec_tokens", [0, 3])
    def test_depth1_pipeline_counters_match(self, models, spec_tokens):
        rng = np.random.default_rng(5)
        prompts = [np.tile(rng.integers(0, VOCAB, size=5), 6)[:25].tolist()
                   for _ in range(5)]
        mnts = [int(rng.integers(8, 20)) for _ in range(5)]
        je = _jax_engine(models, 1, spec_tokens=spec_tokens)
        te = _engine(models, 1, spec_tokens=spec_tokens)
        _, jo = _drive(je, prompts, mnts)
        _, to = _drive(te, prompts, mnts)
        assert to == jo
        for name in ("steps_dispatched", "steps_committed",
                     "async_rollbacks", "occupancy_hist"):
            assert getattr(te, name) == getattr(je, name), name
        for name in ("n_spec_steps", "n_spec_drafted", "n_spec_accepted",
                     "n_spec_emitted"):
            assert te.scheduler.stats[name] == je.scheduler.stats[name], name
        assert te.steps_committed == te.steps_dispatched

    def test_default_depth_is_the_reference_default(self):
        from paddle_tpu.inference.llm.policy import shared_policy
        assert SchedulerConfig().async_depth == policy.ASYNC_DEPTH \
            == shared_policy()["async_depth"] == 0


# -------------------------------------------------------- bit-exact --


class TestBitExact:
    @pytest.mark.parametrize("depth", DEPTHS)
    def test_greedy_everything_on(self, models, depth):
        prompts, mnts = _workload()
        _, o0 = _drive(_engine(models, 0), prompts, mnts)
        e = _engine(models, depth)
        _, o = _drive(e, prompts, mnts)
        assert o == o0
        _assert_restored(e)

    @pytest.mark.parametrize("depth", DEPTHS)
    def test_sampled_everything_on(self, models, depth):
        prompts, mnts = _workload(seed=11)
        sp = SamplingParams(*SAMPLED)
        _, o0 = _drive(_engine(models, 0), prompts, mnts, sp)
        _, o = _drive(_engine(models, depth), prompts, mnts, sp)
        assert o == o0

    @pytest.mark.parametrize("depth", DEPTHS)
    def test_repetitive_spec_heavy_workload(self, models, depth):
        # wide verify rows and held slots: the hold path earns its keep
        rng = np.random.default_rng(5)
        prompts = [np.tile(rng.integers(0, VOCAB, size=5), 6)[:25].tolist()
                   for _ in range(6)]
        mnts = [int(rng.integers(8, 20)) for _ in range(6)]
        e0 = _engine(models, 0, spec_tokens=4)
        e = _engine(models, depth, spec_tokens=4)
        _, o0 = _drive(e0, prompts, mnts)
        _, o = _drive(e, prompts, mnts)
        assert o == o0
        assert e0.scheduler.stats["n_spec_accepted"] > 0
        assert e.scheduler.stats["n_spec_accepted"] > 0

    @pytest.mark.parametrize("depth", DEPTHS)
    def test_eos_mid_stream_rolls_back_inflight_row(self, models, depth):
        prompts, mnts = _workload(seed=9)
        _, base = _drive(_engine(models, 0), prompts, mnts)
        eos = _eos_of(base)
        _, o0 = _drive(_engine(models, 0, eos), prompts, mnts)
        e = _engine(models, depth, eos)
        _, o = _drive(e, prompts, mnts)
        assert o == o0
        assert any(len(x) < m for x, m in zip(o0, mnts)), \
            "EOS never fired: the rollback path was not exercised"
        assert e.async_rollbacks > 0
        assert e.async_rollback_reasons["finished"] == e.async_rollbacks
        _assert_restored(e)

    @pytest.mark.parametrize("depth", DEPTHS)
    def test_preempt_resume_bit_exact(self, models, depth):
        prompts, mnts = _workload(seed=13)
        _, base = _drive(_engine(models, 0), prompts, mnts)
        eng = _engine(models, depth)
        rids = [eng.submit(p, m) for p, m in zip(prompts, mnts)]
        steps = 0
        while eng.scheduler.has_work or eng.pipeline_depth:
            eng.step()
            steps += 1
            if steps in (4, 9):
                victims = [r for r in eng.scheduler.running.values()
                           if r.state == "running"]
                if victims:
                    eng.scheduler.preempt_request(victims[0],
                                                  reason="manual")
        assert [eng.output_of(r) for r in rids] == base
        assert eng.scheduler.stats["n_preemptions"] > 0
        assert eng.async_rollback_reasons["preempted"] > 0
        _assert_restored(eng)

    @pytest.mark.parametrize("kv", ["int8", "fp8"])
    def test_quantized_pages_depths_equal(self, models, kv):
        prompts, mnts = _workload(seed=3)
        outs = [_drive(_engine(models, d, quant=QuantConfig(kv=kv)),
                       prompts, mnts)[1] for d in (0, 1, 2)]
        assert outs[0] == outs[1] == outs[2]

    def test_kv_split_on_and_off_at_depth_one(self, models):
        prompts, mnts = _workload(seed=4)
        q = QuantConfig(kv="int8")
        _, off = _drive(_engine(models, 1, quant=q), prompts, mnts)
        _, on = _drive(_engine(models, 1, quant=q, kv_split_pages=2),
                       prompts, mnts)
        assert on == off


# ------------------------------------------------- rollback/teardown --


class TestRollback:
    @pytest.mark.parametrize("depth", DEPTHS)
    def test_cancel_mid_flight(self, models, depth):
        prompts, mnts = _workload()
        _, base = _drive(_engine(models, 0), prompts, mnts)
        eng = _engine(models, depth)
        rids = [eng.submit(p, m) for p, m in zip(prompts[:3], mnts[:3])]
        for _ in range(3):
            eng.step()
        victim = next(iter(eng.scheduler.running.values()))
        # one rollback per in-flight step that holds a row of the victim
        held = sum(any(r.request is victim for r in stp.plan.rows)
                   for stp in eng._inflight)
        assert held > 0
        assert eng.cancel(victim.rid)
        assert not eng.cancel(victim.rid)          # idempotent
        assert eng.async_rollback_reasons["cancelled"] == held
        eng.run()
        assert eng.scheduler.requests[victim.rid].finish_reason \
            == "cancelled"
        for i, r in enumerate(rids):
            if r != victim.rid:
                assert eng.output_of(r) == base[i]
        _assert_restored(eng)

    @pytest.mark.parametrize("depth", DEPTHS)
    def test_timeout_mid_flight(self, models, depth):
        eng = _engine(models, depth)
        rid = eng.submit([1, 2, 3, 4], 64, deadline_s=1e-9)
        eng.step()          # the sweep at the next step expires it
        eng.step()
        eng.run()
        assert eng.scheduler.requests[rid].finish_reason == "timeout"
        _assert_restored(eng)

    def test_rollback_reasons_prebound(self, models):
        eng = _engine(models, 1)
        assert set(eng.async_rollback_reasons) == {
            "finished", "cancelled", "timeout", "preempted",
            "device_fault"}
        assert sum(eng.async_rollback_reasons.values()) == 0
        assert eng.occupancy_hist == [0, 0]

    @pytest.mark.parametrize("depth", DEPTHS)
    def test_step_counters_track_lag(self, models, depth):
        eng = _engine(models, depth)
        prompts, mnts = _workload(n=4)
        for p, m in zip(prompts, mnts):
            eng.submit(p, m)
        while eng.scheduler.has_work or eng.pipeline_depth:
            eng.step()
            lag = eng.steps_dispatched - eng.steps_committed
            assert 0 <= lag <= depth
            assert lag == eng.pipeline_depth
        assert eng.steps_committed == eng.steps_dispatched
        assert eng.occupancy_hist[depth] > 0


# -------------------------------------------------- compile + mirror --


class TestCompileBoundAndMirror:
    @pytest.mark.parametrize("depth", [0, 1, 2])
    def test_compile_bound(self, models, depth):
        eng = _engine(models, depth)
        prompts, mnts = _workload(n=6)
        _drive(eng, prompts, mnts)
        assert 0 < eng.xla_compiles <= eng.graph_bound
        assert {g[0] for g in eng._graphs} == {"step"}
        # one signature per (bucket, tile rows); buckets 16 and 32 here,
        # of which only 16 holds a step of one-query rows (3 slots)
        assert eng.graph_bound == len(
            eng.scheduler.config.step_buckets()) + 1
        assert set(eng.steps_by_class) <= {"decode", "mix"}
        assert sum(eng.steps_by_class.values()) == eng.steps_dispatched

    @pytest.mark.parametrize("depth", [0, 1])
    def test_page_table_mirror_skips_clean_steps(self, models, depth):
        eng = _engine(models, depth)
        prompts, mnts = _workload(n=6)
        _drive(eng, prompts, mnts)
        assert 0 < eng.pt_uploads < eng.steps_dispatched

    def test_mirror_refreshes_on_table_mutation(self, models):
        eng = _engine(models, 0, spec_tokens=0, chunk_tokens=0)
        eng.submit([1, 2, 3, 4], 4)
        eng.step()                      # allocate -> upload
        up = eng.pt_uploads
        eng.step()                      # pure decode -> no upload
        assert eng.pt_uploads == up
        v = eng.cache.page_table_version
        eng.run()                       # release mutates the table
        assert eng.cache.page_table_version > v
        eng.submit([9, 9, 9], 3)
        eng.step()
        assert eng.pt_uploads > up

    def test_every_step_samples_the_padded_row_count(self, models,
                                                     monkeypatch):
        """``sample_idx`` is padded to ``max_slots * (1 + spec_tokens) +
        1`` entries with ``bucket``, a position nothing reads."""
        seen = []
        real = tengine._step

        def recording(model, cache, levels, ints, floats, carry, bucket,
                      *a, **kw):
            ms = carry.shape[0]
            seen.append((bucket, ints[3 * ms + 5 * bucket:].clone()))
            return real(model, cache, levels, ints, floats, carry, bucket,
                        *a, **kw)

        monkeypatch.setattr(tengine, "_step", recording)
        eng = _engine(models, 1)
        prompts, mnts = _workload(n=4)
        _drive(eng, prompts, mnts)
        n_sample = 3 * (1 + 3) + 1
        assert seen and all(len(idx) == n_sample for _, idx in seen)
        for bucket, idx in seen:
            real_idx = idx[idx != bucket]
            assert len(real_idx) >= 1 and bool((real_idx < bucket).all())
            assert int(idx[-1]) == bucket     # at least one pad

    def test_cuda_graphs_need_the_card(self, models):
        with pytest.raises(ValueError, match="CUDA"):
            GenerationEngine(models[1], scheduler_config=SchedulerConfig(
                max_slots=2, max_seq_len=64), device="cpu",
                cuda_graphs=True)
        assert not _engine(models, 1).cuda_graphs

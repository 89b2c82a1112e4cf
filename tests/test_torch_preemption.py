"""The port's multi-tenant serving against the JAX package's
(``tests/test_preemption.py``), on the CPU: priority classes, tenant
quotas, typed submit validation, cancellation at every stage,
deadlines, SLO preemption with the host swap tier, and the one terminal
event per request.

Both engines serve the JAX package's tiny model (its weights carried
over with ``params_from_jax``). Where the scenario is deterministic
(no wall-clock deadline) the port runs beside the JAX engine and must
give its tokens, finish reasons, admission order, preemption counts and
swap counters; the preempt-and-resume cases hold the port at depths 0
and 1 to its own unpreempted run, whether the KV comes back from the
swap tier or from a re-prefill. The swap tier moves pages byte for byte
(float32, int8 and fp8 pages with their scale rows), checked against
the JAX cache on the same page contents.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.inference.llm import CacheConfig as JaxCacheConfig  # noqa: E402
from paddle_tpu.inference.llm import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu.inference.llm import JaxLM  # noqa: E402
from paddle_tpu.inference.llm import PagedKVCache as JaxCache  # noqa: E402
from paddle_tpu.inference.llm import SamplingParams as JaxSP  # noqa: E402
from paddle_tpu.inference.llm import (  # noqa: E402
    SchedulerConfig as JaxSchedulerConfig)
from paddle_tpu.inference.llm import kv_cache as jkv  # noqa: E402
from paddle_tpu.inference.llm.policy import shared_policy  # noqa: E402
from paddle_tpu_torch.inference.llm import (  # noqa: E402
    CacheConfig, GenerationEngine, InvalidRequest, PagedKVCache,
    SamplingParams, SchedulerConfig, TorchLM, policy)
from paddle_tpu_torch.inference.llm.model import params_from_jax  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

VOCAB = 64
SAMPLED = (0.9, 20, 0.95, 42)
SWAP_COUNTERS = ("swapped_out_pages", "swapped_in_pages", "swap_evictions",
                 "demoted_pages", "num_swapped_pages")


@pytest.fixture(scope="module")
def models():
    jm = JaxLM.tiny(vocab=VOCAB, d_model=32, num_layers=2, num_heads=2,
                    head_dim=16, max_seq_len=128, seed=7)
    np_params = {k: np.asarray(v) for k, v in jm.params.items()}
    return jm, TorchLM(jm.spec, params_from_jax(np_params, "cpu"),
                       device="cpu")


def _geom(max_slots=2, num_pages=64, page_size=8, swap=64, prefix=True):
    return dict(num_layers=2, num_heads=2, head_dim=16, max_slots=max_slots,
                num_pages=num_pages, page_size=page_size, max_seq_len=128,
                prefix_cache=prefix, swap_pages=swap)


def _engine(models, geom=None, side="torch", depth=0, **kw):
    cfg = dict(max_slots=2, min_bucket=8, max_seq_len=128,
               priority_classes=3, async_depth=depth)
    cfg.update(kw)
    geom = geom or _geom(max_slots=cfg["max_slots"])
    if side == "jax":
        eng = JaxEngine(models[0], cache_config=JaxCacheConfig(**geom),
                        scheduler_config=JaxSchedulerConfig(**cfg))
        eng.stepprof.disable()
        return eng
    return GenerationEngine(models[1], cache_config=CacheConfig(**geom),
                            scheduler_config=SchedulerConfig(**cfg),
                            device="cpu")


def _both(models, geom=None, **kw):
    return (_engine(models, geom, "jax", **kw),
            _engine(models, geom, "torch", **kw))


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, size=n).tolist()


def _sp(eng, sampling):
    if sampling is None:
        return None
    return (SamplingParams if isinstance(eng, GenerationEngine)
            else JaxSP)(*sampling)


def _run_until_output(eng, rid, n, max_steps=500):
    req = eng.scheduler.requests[rid]
    steps = 0
    while len(req.output) < n:
        eng.step()
        steps += 1
        assert steps < max_steps, "request made no progress"
    return req


def _admit_order(eng, rids):
    return sorted(rids, key=lambda r: eng.scheduler.requests[r].t_admit)


def _summary(eng, rids):
    reqs = eng.scheduler.requests
    st = eng.scheduler.stats
    return ([list(reqs[r].output) for r in rids],
            [reqs[r].finish_reason for r in rids],
            [reqs[r].preemptions for r in rids],
            [reqs[r].restored_tokens for r in rids],
            {k: st[k] for k in ("n_preemptions", "n_resumed",
                                "n_preempt_drops", "n_quota_deferred",
                                "n_cancelled", "n_timeouts")},
            {k: getattr(eng.cache, k) for k in SWAP_COUNTERS})


def _restored(eng, free0=None):
    eng.cache.check_invariants()
    want = eng.cache.config.num_pages - 1 if free0 is None else free0
    assert eng.cache.num_free_pages == want


class TestPolicy:
    def test_knobs_match_the_reference(self, monkeypatch):
        for key in ("PD_PRIORITY_CLASSES", "PD_TENANT_MAX_PAGES",
                    "PD_TENANT_MAX_SLOTS"):
            monkeypatch.delenv(key, raising=False)
        ref = shared_policy()
        assert policy.PRIORITY_CLASSES == ref["priority_classes"]
        assert policy.TENANT_MAX_PAGES == ref["tenant_max_pages"]
        assert policy.TENANT_MAX_SLOTS == ref["tenant_max_slots"]
        cfg, jcfg = SchedulerConfig(), JaxSchedulerConfig()
        assert (cfg.priority_classes, cfg.preempt) == \
            (jcfg.priority_classes, jcfg.preempt)


class TestPriorityAdmission:
    def test_class_order_beats_fifo(self, models):
        """With one slot, a later class-0 request is admitted before
        earlier class-1/2 ones — in both engines, in the same order."""
        orders = []
        for eng in _both(models, max_slots=1, preempt=False):
            occupant = eng.submit(_prompt(8, 1), 24, priority=1)
            eng.step()
            low = eng.submit(_prompt(8, 2), 4, priority=2)
            mid = eng.submit(_prompt(8, 3), 4, priority=1)
            high = eng.submit(_prompt(8, 4), 4, priority=0)
            eng.run()
            rids = [occupant, low, mid, high]
            order = _admit_order(eng, rids)
            assert order == [occupant, high, mid, low]
            orders.append([rids.index(r) for r in order])
        assert orders[0] == orders[1]

    def test_same_class_stays_fifo(self, models):
        eng = _engine(models, max_slots=1, preempt=False)
        rids = [eng.submit(_prompt(6, i), 3, priority=1) for i in range(4)]
        eng.run()
        assert _admit_order(eng, rids) == rids

    def test_tenant_slot_quota_defers_without_blocking(self, models):
        """Tenant a at its slot quota is skipped: tenant b's later
        request runs while a's second waits."""
        out = []
        for eng in _both(models, max_slots=2, tenant_max_slots=1,
                         preempt=False):
            a1 = eng.submit(_prompt(8, 1), 24, tenant="a")
            a2 = eng.submit(_prompt(8, 2), 4, tenant="a")
            b1 = eng.submit(_prompt(8, 3), 4, tenant="b")
            eng.run()
            reqs = eng.scheduler.requests
            assert reqs[b1].t_admit < reqs[a2].t_admit
            assert reqs[a2].t_admit >= reqs[a1].t_finish
            assert eng.scheduler.stats["n_quota_deferred"] > 0
            out.append(_summary(eng, [a1, a2, b1]))
        assert out[0] == out[1]

    def test_tenant_page_quota_enforced(self, models):
        out = []
        for eng in _both(models, max_slots=2, tenant_max_pages=8,
                         preempt=False):
            # each needs pages_for(8 + 24) = 4 pages: two running hold 8
            rids = [eng.submit(_prompt(8, i), 24, tenant="a")
                    for i in range(3)]
            for _ in range(6):
                eng.step()
            held = [eng.scheduler.requests[r] for r in rids]
            assert sum(1 for r in held if r.slot >= 0) == 2
            eng.run()
            assert all(r.state == "finished" for r in held)
            out.append(_summary(eng, rids))
        assert out[0] == out[1]

    def test_tenant_usage_reports_running_holdings(self, models):
        eng = _engine(models, max_slots=2)
        eng.submit(_prompt(8, 1), 24, tenant="a")
        eng.submit(_prompt(8, 2), 8, tenant="b")
        for _ in range(3):
            eng.step()
        usage = eng.scheduler.tenant_usage()
        assert usage["a"]["slots"] == usage["b"]["slots"] == 1
        assert usage["a"]["pages"] == 4 and usage["b"]["pages"] == 2
        assert usage["a"]["tokens"] > 0

    def test_quota_impossible_request_rejected_typed(self, models):
        eng = _engine(models, tenant_max_pages=2)
        with pytest.raises(InvalidRequest):
            eng.submit(_prompt(40), 40)   # needs 10 pages > quota forever


class TestSubmitValidation:
    @pytest.mark.parametrize("kw", [
        dict(prompt=[], mnt=4),
        dict(prompt=[1, 2, 3], mnt=0),
        dict(prompt=[1, 2, 3], mnt=-2),
        dict(prompt=list(range(120)), mnt=40),      # > max_seq_len
        dict(prompt=[1, 2, 3], mnt=4, priority=7),  # outside classes
        dict(prompt=[1, 2, 3], mnt=4, priority=-1),
        dict(prompt=[1, 2, 3], mnt=4, ttft_deadline_s=-0.5),
        dict(prompt=[1, 2, 3], mnt=4, deadline_s=-1.0),
    ])
    def test_typed_rejection_burns_nothing(self, models, kw):
        """A malformed submit raises InvalidRequest on both sides before
        a rid or a seed is drawn: the next sampled request's tokens are
        unchanged."""
        eng = _engine(models)
        sch = eng.scheduler
        rid_before = sch._next_rid
        rng_before = eng._rng.bit_generator.state
        args = dict(priority=kw.get("priority", 0),
                    ttft_deadline_s=kw.get("ttft_deadline_s", 0.0),
                    deadline_s=kw.get("deadline_s", 0.0))
        with pytest.raises(InvalidRequest):
            eng.submit(kw["prompt"], kw["mnt"], **args)
        with pytest.raises(Exception) as jerr:
            _engine(models, side="jax").submit(kw["prompt"], kw["mnt"],
                                               **args)
        assert type(jerr.value).__name__ == "InvalidRequest"
        assert sch._next_rid == rid_before
        assert eng._rng.bit_generator.state == rng_before
        assert sch.stats["n_submitted"] == 0
        assert sch.num_waiting == 0

    def test_whole_pool_overflow_is_typed(self, models):
        eng = _engine(models, geom=_geom(num_pages=5))
        with pytest.raises(InvalidRequest):
            eng.submit(_prompt(30), 30)   # needs 8 pages, pool has 4


class TestCancellation:
    def test_cancel_queued(self, models):
        eng = _engine(models, max_slots=1)
        free0 = eng.cache.num_free_pages
        blocker = eng.submit(_prompt(8, 1), 16)
        queued = eng.submit(_prompt(8, 2), 4)
        eng.step()
        assert eng.cancel(queued)
        req = eng.scheduler.requests[queued]
        assert (req.state, req.finish_reason) == ("finished", "cancelled")
        eng.run()
        assert eng.scheduler.requests[blocker].finish_reason
        _restored(eng, free0)

    @pytest.mark.parametrize("depth", [0, 1])
    def test_cancel_mid_decode(self, models, depth):
        eng = _engine(models, depth=depth)
        free0 = eng.cache.num_free_pages
        rid = eng.submit(_prompt(10, 3), 30)
        _run_until_output(eng, rid, 4)
        assert eng.cancel(rid)
        req = eng.scheduler.requests[rid]
        assert (req.state, req.finish_reason, req.slot) == \
            ("finished", "cancelled", -1)
        eng.run()
        assert not eng.scheduler.has_work and eng.pipeline_depth == 0
        _restored(eng, free0)

    def test_cancel_mid_chunked_prefill(self, models):
        eng = _engine(models, chunk_tokens=16)
        free0 = eng.cache.num_free_pages
        rid = eng.submit(_prompt(60, 4), 8)
        eng.step()   # first chunk only: the request is mid-prefill
        req = eng.scheduler.requests[rid]
        assert req.state == "prefill" and 0 < req.prefill_pos < 60
        assert eng.cancel(rid)
        assert req.finish_reason == "cancelled"
        assert eng.scheduler._chunking is None
        other = eng.submit(_prompt(12, 5), 4)
        eng.run()
        assert eng.scheduler.requests[other].finish_reason
        _restored(eng, free0)

    def test_cancel_mid_verify_spec_decode(self, models):
        eng = _engine(models, spec_tokens=4)
        free0 = eng.cache.num_free_pages
        block = np.tile(np.arange(5), 12)[:40].tolist()   # draftable
        rid = eng.submit(block, 24)
        _run_until_output(eng, rid, 6)
        assert eng.cancel(rid)
        assert eng.scheduler.requests[rid].finish_reason == "cancelled"
        _restored(eng, free0)

    def test_cancel_idempotent_and_unknown(self, models):
        eng = _engine(models)
        rid = eng.submit(_prompt(8, 6), 2)
        eng.run()
        assert not eng.cancel(rid)       # already terminal
        assert not eng.cancel(10**9)     # unknown
        assert eng.scheduler.requests[rid].finish_reason == "max_new_tokens"


class TestDeadlines:
    def test_queued_ttft_deadline_times_out(self, models):
        eng = _engine(models, max_slots=1)
        blocker = eng.submit(_prompt(8, 1), 20)
        doomed = eng.submit(_prompt(8, 2), 4, ttft_deadline_s=1e-4)
        eng.step()
        time.sleep(0.002)
        eng.step()   # the sweep runs before the plan
        req = eng.scheduler.requests[doomed]
        assert (req.state, req.finish_reason) == ("finished", "timeout")
        eng.run()
        assert eng.scheduler.requests[blocker].finish_reason
        assert eng.scheduler._live_deadlines == 0
        _restored(eng)

    @pytest.mark.parametrize("depth", [0, 1])
    def test_running_total_deadline_times_out(self, models, depth):
        eng = _engine(models, depth=depth)
        free0 = eng.cache.num_free_pages
        rid = eng.submit(_prompt(10, 3), 100, deadline_s=0.05)
        _run_until_output(eng, rid, 1)
        deadline = time.perf_counter() + 5.0
        req = eng.scheduler.requests[rid]
        while req.state != "finished":
            assert time.perf_counter() < deadline, "deadline never fired"
            eng.step()
        eng.run()
        assert req.finish_reason == "timeout"
        assert 0 < len(req.output) < 100   # torn down mid-decode
        assert eng.scheduler.stats["n_timeouts"] == 1
        _restored(eng, free0)

    def test_no_deadline_never_times_out(self, models):
        eng = _engine(models)
        rid = eng.submit(_prompt(8, 4), 6)
        eng.run()
        assert eng.scheduler.requests[rid].finish_reason == "max_new_tokens"
        assert eng.scheduler.stats["n_timeouts"] == 0


class TestPreemption:
    @pytest.mark.parametrize("depth", [0, 1])
    def test_page_pressure_evicts_lowest_priority(self, models, depth):
        """16 usable pages; a 14-page hog is evicted for a class-0
        arrival, resumes from cache and swap, and both finish. The port
        at depth 0 and 1 matches the JAX engine at the same depth."""
        out = []
        geom = _geom(max_slots=2, num_pages=17)
        for eng in _both(models, geom, max_seq_len=110, depth=depth):
            hog = eng.submit(_prompt(80, 1), 30, priority=2, tenant="hog")
            for _ in range(6):
                eng.step()
            vip = eng.submit(_prompt(60, 2), 8, priority=0, tenant="vip")
            eng.run()
            reqs = eng.scheduler.requests
            assert eng.scheduler.stats["n_preemptions"] == 1
            assert reqs[hog].finish_reason == "max_new_tokens"
            assert len(reqs[hog].output) == 30
            assert reqs[hog].restored_tokens > 0
            assert eng.cache.swapped_in_pages > 0
            assert eng.cache.num_free_pages == 16
            eng.cache.check_invariants()
            out.append(_summary(eng, [hog, vip]))
        assert out[0] == out[1]

    def test_slot_pressure_evicts_most_recent_victim(self, models):
        out = []
        for eng in _both(models, max_slots=2):
            lo1 = eng.submit(_prompt(24, 1), 40, priority=2)
            lo2 = eng.submit(_prompt(24, 2), 40, priority=2)
            for _ in range(8):
                eng.step()
            vip = eng.submit(_prompt(16, 3), 6, priority=0)
            eng.run()
            reqs = eng.scheduler.requests
            assert (reqs[lo1].preemptions, reqs[lo2].preemptions) == (0, 1)
            assert all(len(reqs[r].output) == n
                       for r, n in ((lo1, 40), (lo2, 40), (vip, 6)))
            eng.cache.check_invariants()
            out.append(_summary(eng, [lo1, lo2, vip]))
        assert out[0] == out[1]

    def test_preempt_disabled_waits_instead(self, models):
        eng = _engine(models, max_slots=1, preempt=False)
        lo = eng.submit(_prompt(8, 1), 16, priority=2)
        for _ in range(3):
            eng.step()
        vip = eng.submit(_prompt(8, 2), 4, priority=0)
        eng.run()
        assert eng.scheduler.stats["n_preemptions"] == 0
        reqs = eng.scheduler.requests
        assert reqs[vip].t_admit >= reqs[lo].t_finish

    def test_equal_priority_never_preempts(self, models):
        eng = _engine(models, max_slots=1)
        a = eng.submit(_prompt(8, 1), 16, priority=1)
        for _ in range(3):
            eng.step()
        b = eng.submit(_prompt(8, 2), 4, priority=1)
        eng.run()
        assert eng.scheduler.stats["n_preemptions"] == 0
        assert eng.scheduler.requests[a].preemptions == 0
        assert eng.scheduler.requests[b].finish_reason

    def test_preempt_drop_when_queue_full(self, models):
        """A victim that cannot re-queue ends with finish_reason
        'preempted', in both engines."""
        out = []
        for eng in _both(models, max_slots=1, max_queue=1):
            free0 = eng.cache.num_free_pages
            lo = eng.submit(_prompt(8, 1), 24, priority=2)
            for _ in range(3):
                eng.step()
            vip = eng.submit(_prompt(8, 2), 4, priority=0)
            eng.run()
            reqs = eng.scheduler.requests
            assert reqs[lo].finish_reason == "preempted"
            assert eng.scheduler.stats["n_preempt_drops"] == 1
            assert reqs[vip].finish_reason == "max_new_tokens"
            assert eng.cache.num_free_pages == free0
            out.append(_summary(eng, [lo, vip]))
        assert out[0] == out[1]

    def test_manual_preempt_requeues_at_class_front(self, models):
        eng = _engine(models, max_slots=1)
        a = eng.submit(_prompt(8, 1), 20, priority=1)
        eng.submit(_prompt(8, 2), 4, priority=1)
        for _ in range(3):
            eng.step()
        assert eng.scheduler.preempt(a, reason="manual")
        assert eng.scheduler.waiting[0].rid == a
        eng.run()
        reqs = eng.scheduler.requests
        assert reqs[a].finish_reason == "max_new_tokens"
        assert len(reqs[a].output) == 20

    @pytest.mark.parametrize("sampling", [None, SAMPLED],
                             ids=["greedy", "sampled"])
    def test_contended_mix_at_depth_one_matches_jax(self, models, sampling):
        """Three tenants and three classes on a pool too small for every
        request at once, at async depth 1: high-priority arrivals preempt
        low ones (swap out, swap in), a tenant is held at its slot quota.
        Tokens, reasons, preemptions and swap counters equal the JAX
        engine's."""
        out = []
        geom = _geom(max_slots=3, num_pages=25, swap=32)
        for eng in _both(models, geom, max_slots=3, depth=1,
                         tenant_max_slots=2, chunk_tokens=16):
            sp = _sp(eng, sampling)
            rids = [eng.submit(_prompt(40, i), 24, sp, priority=2,
                               tenant="bulk") for i in range(3)]
            for _ in range(8):
                eng.step()
            rids += [eng.submit(_prompt(30, 10 + i), 10, sp, priority=0,
                                tenant=f"vip{i % 2}") for i in range(3)]
            rids += [eng.submit(_prompt(12, 20), 6, sp, priority=1,
                                tenant="mid")]
            eng.run()
            assert eng.scheduler.stats["n_preemptions"] > 0
            assert eng.cache.swapped_in_pages > 0
            assert all(eng.scheduler.requests[r].finish_reason
                       == "max_new_tokens" for r in rids)
            eng.cache.check_invariants()
            out.append(_summary(eng, rids))
        assert out[0] == out[1]


class TestBitExactResume:
    def _baseline(self, models, prompt, mnt, sampling, **kw):
        eng = _engine(models, **kw)
        rid = eng.submit(prompt, mnt, sampling=_sp(eng, sampling))
        eng.run()
        return eng.output_of(rid)

    @pytest.mark.parametrize("depth", [0, 1])
    @pytest.mark.parametrize("sampling", [None, SAMPLED],
                             ids=["greedy", "sampled"])
    @pytest.mark.parametrize("chunk,swap", [(0, 64), (16, 64), (0, 0)],
                             ids=["swap", "chunk+swap", "replay"])
    def test_preempt_resume_bit_exact(self, models, sampling, chunk, swap,
                                      depth):
        """A preempted-then-resumed request delivers the tokens of its
        unpreempted run, whether the KV comes back from the swap tier
        (byte-identical pages) or from a full re-prefill."""
        prompt = _prompt(37, 7)
        kw = dict(chunk_tokens=chunk, geom=_geom(swap=swap, prefix=swap > 0))
        base = self._baseline(models, prompt, 20, sampling, **kw)
        eng = _engine(models, depth=depth, **kw)
        free0 = eng.cache.num_free_pages
        rid = eng.submit(prompt, 20, sampling=_sp(eng, sampling))
        req = _run_until_output(eng, rid, 8)
        assert eng.scheduler.preempt(rid, reason="manual")
        assert req.state == "preempted"
        eng.run()
        assert eng.output_of(rid) == base
        assert req.preemptions == 1
        assert (req.restored_tokens > 0) == (swap > 0)
        # the preemption copied the resident pages to the host store;
        # alone in the pool, the resume then maps them from the prefix
        # cache (the page-pressure and contended cases swap them in)
        assert (eng.cache.swapped_out_pages > 0) == (swap > 0)
        _restored(eng, free0)

    def test_resume_bit_exact_with_spec_decoding(self, models):
        block = np.tile(np.arange(6), 10)[:42].tolist()
        base = self._baseline(models, block, 24, None, spec_tokens=4)
        assert base == self._baseline(models, block, 24, None)
        eng = _engine(models, spec_tokens=4)
        rid = eng.submit(block, 24)
        _run_until_output(eng, rid, 8)
        assert eng.scheduler.preempt(rid, reason="manual")
        eng.run()
        assert eng.output_of(rid) == base
        eng.cache.check_invariants()

    def test_double_preempt_still_bit_exact(self, models):
        prompt = _prompt(30, 11)
        base = self._baseline(models, prompt, 18, SAMPLED)
        eng = _engine(models)
        rid = eng.submit(prompt, 18, sampling=SamplingParams(*SAMPLED))
        _run_until_output(eng, rid, 4)
        assert eng.scheduler.preempt(rid)
        _run_until_output(eng, rid, 10)
        assert eng.scheduler.preempt(rid)
        eng.run()
        assert eng.output_of(rid) == base
        assert eng.scheduler.requests[rid].preemptions == 2


class TestSwapTier:
    GEOM = dict(num_layers=2, num_heads=2, head_dim=16, num_pages=12,
                page_size=4, max_slots=2, max_seq_len=32, swap_pages=3)

    def _caches(self, kv, **kw):
        geom = dict(self.GEOM, kv_quant=kv, **kw)
        return JaxCache(JaxCacheConfig(**geom)), PagedKVCache(
            CacheConfig(**geom), device="cpu")

    @staticmethod
    def _fill(j, t, seed):
        """The same random page contents in both caches' pools (codes
        and scale rows for quantized pages)."""
        import jax.numpy as jnp
        rng = np.random.default_rng(seed)
        names = ["k_pool", "v_pool"] + (
            ["k_scale", "v_scale"] if t.k_scale is not None else [])
        for name in names:
            pool = getattr(t, name)
            if pool.dtype == torch.float8_e4m3fn:
                raw = rng.integers(0, 256, size=pool.shape).astype(np.uint8)
                raw[(raw & 0x7F) == 0x7F] = 0          # no NaN codes
                pool.view(torch.uint8).copy_(torch.from_numpy(raw))
                jval = jnp.asarray(raw).view(jnp.float8_e4m3fn)
            elif pool.dtype == torch.int8:
                raw = rng.integers(-127, 128, size=pool.shape).astype(np.int8)
                pool.copy_(torch.from_numpy(raw))
                jval = jnp.asarray(raw)
            else:
                raw = rng.standard_normal(pool.shape).astype(np.float32)
                pool.copy_(torch.from_numpy(raw))
                jval = jnp.asarray(raw)
            setattr(j, name, jval)

    @staticmethod
    def _page_bytes(cache, page):
        names = ["k_pool", "v_pool"] + (
            ["k_scale", "v_scale"] if cache.k_scale is not None else [])
        out = []
        for name in names:
            arr = getattr(cache, name)
            if isinstance(arr, torch.Tensor):
                a = arr[:, page]
                a = (a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn
                     else a).numpy()
            else:
                a = np.asarray(arr[:, page])
                if a.dtype.itemsize == 1 and a.dtype.kind not in "iu":
                    a = a.view(np.uint8)
            out.append(a.tobytes())
        return out

    @pytest.mark.parametrize("kv", ["off", "int8", "fp8"])
    def test_swap_round_trip_byte_for_byte(self, kv):
        """swap_out of a slot's full resident pages, release, then a new
        allocation swaps them back: the restored pages hold the same
        bytes as the originals (codes and scale rows), on both caches,
        with equal counters and prefix lengths."""
        j, t = self._caches(kv, prefix_cache=False)
        self._fill(j, t, seed=1)
        tokens = list(range(10))                 # two full pages + 2
        for c in (j, t):
            assert c.allocate(0, 14, prompt=tokens)
            c.seq_lens[0] = len(tokens)
        want = [self._page_bytes(c, p) for c, p in
                ((j, j._allocated_pages[0][0]), (t, t._allocated_pages[0][0]))]
        assert want[0] == want[1]
        orig = {i: self._page_bytes(t, t._allocated_pages[0][i])
                for i in range(2)}
        for c in (j, t):
            assert c.swap_out(0, tokens) == 2
            c.release(0)
        # scribble over the freed pages: the restore must not read them
        t.k_pool.view(torch.uint8).fill_(0) if kv == "fp8" else \
            t.k_pool.zero_()
        for c in (j, t):
            assert c.allocate(1, 14, prompt=tokens)
            assert c.swap_in(1, tokens) == 2
            assert c.prefix_len(1) == 8
        for i in range(2):
            assert self._page_bytes(t, t._allocated_pages[1][i]) == orig[i]
        for name in ("swapped_out_pages", "swapped_in_pages",
                     "num_swapped_pages", "swap_evictions"):
            assert getattr(t, name) == getattr(j, name), name
        t.check_invariants()

    @pytest.mark.parametrize("kv", ["off", "int8"])
    def test_demotion_on_eviction_and_on_demand_match(self, kv):
        """Parked prefix pages spill to the host store when evicted under
        pressure and on ``demote_prefix_pages``; a later hit swaps them
        back. Counters and page accounting equal the JAX cache's after
        every operation, and the store stays within its budget."""
        j, t = self._caches(kv)
        self._fill(j, t, seed=2)
        a = list(range(100, 113))                # 3 full pages
        b = list(range(200, 213))
        for c in (j, t):
            for slot, p in ((0, a), (1, b)):
                assert c.allocate(slot, len(p) + 1, prompt=p)
                c.seq_lens[slot] = len(p)
                c.commit_prefix(slot, p)
                c.release(slot)
            assert c.demote_prefix_pages(2) == 2
            # pressure: a large allocation evicts (and demotes) the rest
            assert c.allocate(0, 32, prompt=list(range(300, 332)))
            c.release(0)
            # a's content comes back from the store at admission
            assert c.allocate(1, len(a) + 1, prompt=a)
            c.swap_in(1, a)

        def state(c):
            return ([getattr(c, n) for n in SWAP_COUNTERS[:-1]]
                    + [c.num_swapped_pages, c.prefix_evictions,
                       c.prefix_len(1), sorted(c._free),
                       list(c._allocated_pages[1])])
        assert state(t) == state(j)
        assert t.demoted_pages > 0 and t.swapped_in_pages > 0
        assert t.num_swapped_pages <= self.GEOM["swap_pages"]
        t.check_invariants()

    def test_defaults_and_quant_key_match_the_reference(self):
        assert policy.SWAP_PAGES_DEFAULT == jkv._swap_pages_default()
        assert policy.COLD_DEMOTE_DEFAULT == jkv.COLD_DEMOTE_DEFAULT
        for kv in ("off", "int8"):
            j, t = self._caches(kv)
            assert t.swap_quant_key == j.swap_quant_key

    def test_swap_off_copies_nothing(self):
        j, t = self._caches("off", swap_pages=0, prefix_cache=False)
        tokens = list(range(10))
        for c in (j, t):
            assert c.allocate(0, 12, prompt=tokens)
            c.seq_lens[0] = 10
            assert c.swap_out(0, tokens) == 0
            c.release(0)
            assert c.demote_prefix_pages() == 0
        assert t.num_swapped_pages == j.num_swapped_pages == 0


class TestTerminalIdempotency:
    def test_retire_is_idempotent_once(self, models):
        eng = _engine(models, max_slots=1)
        sch = eng.scheduler
        rid = eng.submit(_prompt(8, 1), 8)
        eng.step()
        req = sch.requests[rid]
        assert eng.cancel(rid)
        finished_1 = sch.stats["n_finished"]
        sch._retire(req, "timeout")       # a racing sweep lands after
        assert req.finish_reason == "cancelled"
        assert sch.stats["n_finished"] == finished_1
        assert sch.stats["n_timeouts"] == 0

    def test_cancel_racing_sweep_one_terminal_state(self, models):
        eng = _engine(models, max_slots=1)
        sch = eng.scheduler
        running = eng.submit(_prompt(8, 2), 16, deadline_s=500.0)
        queued = eng.submit(_prompt(8, 3), 4, deadline_s=500.0)
        eng.step()
        assert eng.cancel(running)
        assert eng.cancel(queued)
        for rid in (running, queued):    # force both deadlines expired
            sch.requests[rid].t_submit -= 1000.0
        sch.sweep_deadlines()
        for rid in (running, queued):
            assert sch.requests[rid].finish_reason == "cancelled"
        assert sch.stats["n_timeouts"] == 0
        assert sch.stats["n_finished"] == 2
        eng.cache.check_invariants()

    def test_sweep_then_cancel_is_idempotent(self, models):
        eng = _engine(models, max_slots=1)
        sch = eng.scheduler
        rid = eng.submit(_prompt(8, 4), 16, ttft_deadline_s=1e-9)
        sch.sweep_deadlines()
        req = sch.requests[rid]
        assert req.finish_reason == "timeout"
        assert not eng.cancel(rid)
        assert req.finish_reason == "timeout"
        assert sch.stats["n_finished"] == 1
        assert sch.stats["n_cancelled"] == 0

    def test_live_deadline_count_not_double_decremented(self, models):
        eng = _engine(models, max_slots=1)
        sch = eng.scheduler
        rid = eng.submit(_prompt(8, 5), 8, deadline_s=1e-9)
        req = sch.requests[rid]
        assert sch._live_deadlines == 1
        assert eng.cancel(rid)
        sch._retire(req, "timeout")
        assert sch._live_deadlines == 0

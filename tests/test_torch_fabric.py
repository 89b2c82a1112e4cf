"""The port's replicated serving fabric against the JAX fabric.

Both fabrics serve ``JaxLM.tiny``'s weights (carried across with
``params_from_jax``) under the same fabric, cache and scheduler configs
and the same submissions, the cases of ``tests/test_fabric.py``:

- **routing**: per request, the placement (replica, reason, held pages)
  equals the JAX fabric's, request by request in submission order; the
  placement is deterministic, follows the prefix holder, spills past the
  queue gap and balances by load without a prefix;
- **kill relocation** at every lifecycle stage (queued, mid-chunk,
  mid-decode, mid-verify), at async depth 1, by drain, onto a lone
  replica's respawn and on the prefill replica of a disaggregated
  fabric: outputs bit-exact against one uninterrupted port engine AND
  equal to the JAX fabric's, greedy and sampled (``seed=None``
  included), pools restored;
- **disaggregation**: outputs bit-exact, real handoffs, cancel before
  handoff, handoff backpressure;
- **chaos** with a replica kill, the ``pd_fabric_*`` families at zero
  and counting placements, and the config degrade rules and defaults.

Token equality across the two backends is exact: the tiny model's
float32 logits agree to ~1e-6 and the workloads' greedy and sampled
decisions sit far from ties (the JAX engine tests' premise).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu import observability as jobs  # noqa: E402
from paddle_tpu.inference.llm import (  # noqa: E402
    CacheConfig as JCacheConfig, FabricConfig as JFabricConfig,
    FaultConfig as JFaultConfig, FaultInjector as JFaultInjector, JaxLM,
    SamplingParams as JSP, SchedulerConfig as JSchedulerConfig,
    ServingFabric as JFabric, run_chaos as jrun_chaos,
    set_default_injector as jset_default_injector)
import paddle_tpu_torch.observability as tobs  # noqa: E402
from paddle_tpu_torch.inference.llm import (  # noqa: E402
    CacheConfig, FabricConfig, FaultConfig, FaultInjector,
    GenerationEngine, SamplingParams, SchedulerConfig, ServingFabric,
    TorchLM, run_chaos, set_default_injector)
from paddle_tpu_torch.inference.llm import policy  # noqa: E402
from paddle_tpu_torch.inference.llm.fabric import ROUTE_REASONS  # noqa: E402
from paddle_tpu_torch.inference.llm.model import params_from_jax  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

VOCAB = 64


@pytest.fixture(scope="module")
def lms():
    jm = JaxLM.tiny(vocab=VOCAB, d_model=32, num_layers=2, num_heads=2,
                    head_dim=16, max_seq_len=128, seed=7)
    tm = TorchLM(jm.spec, params_from_jax(
        {k: np.asarray(v) for k, v in jm.params.items()}, "cpu"),
        device="cpu")
    return jm, tm


@pytest.fixture
def injectors():
    """Install the same fresh injector config as the process default of
    both packages, restoring the old ones after."""
    saved = []

    def _install(**rates):
        tinj = FaultInjector(FaultConfig(**rates))
        jinj = JFaultInjector(JFaultConfig(**rates))
        saved.append((set_default_injector(tinj),
                      jset_default_injector(jinj)))
        return tinj, jinj

    yield _install
    while saved:
        t, j = saved.pop()
        set_default_injector(t)
        jset_default_injector(j)


CACHE = dict(num_layers=2, num_heads=2, head_dim=16, num_pages=64,
             page_size=8, max_seq_len=128, prefix_cache=True, swap_pages=64)


def _sched(**kw):
    cfg = dict(max_slots=2, min_bucket=8, max_seq_len=128, chunk_tokens=8,
               spec_tokens=3, priority_classes=3, max_queue=32)
    cfg.update(kw)
    return cfg


def _fabrics(lms, replicas=2, roles="colocated", spill=0, **kw):
    """(port fabric, JAX fabric) of the same configuration."""
    jm, tm = lms
    cache = dict(CACHE, max_slots=kw.get("max_slots", 2))
    t = ServingFabric(tm, FabricConfig(replicas=replicas, roles=roles,
                                       spill=spill),
                      cache_config=CacheConfig(**cache),
                      scheduler_config=SchedulerConfig(**_sched(**kw)),
                      device="cpu")
    j = JFabric(jm, JFabricConfig(replicas=replicas, roles=roles,
                                  spill=spill),
                cache_config=JCacheConfig(**cache),
                scheduler_config=JSchedulerConfig(**_sched(**kw)))
    return t, j


def _workload(n=6, seed=0):
    """tests/test_fabric.py's workload: greedy, seed=None sampled and
    explicit-seed sampled rows with repetitive tails (the n-gram drafter
    proposes, so mid-verify kills see real verify rows)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        block = rng.integers(0, VOCAB, size=6).tolist()
        prompt = (block * 5)[:18 + int(rng.integers(0, 10))]
        if i % 3 == 0:
            sp = None
        elif i % 3 == 1:
            sp = dict(temperature=0.9, top_k=16, top_p=0.95)
        else:
            sp = dict(temperature=0.8, top_k=8, seed=100 + i)
        out.append((prompt, 8 + i % 4, sp))
    return out


def _submit_all(target, workload, jax_side=False):
    cls = JSP if jax_side else SamplingParams
    return [target.submit(p, mnt, None if sp is None else cls(**sp))
            for p, mnt, sp in workload]


def _baseline(lms, workload, **kw):
    """One uninterrupted port engine, same submission order: the
    bit-exact reference of every fabric topology."""
    _, tm = lms
    eng = GenerationEngine(tm, cache_config=CacheConfig(**CACHE,
                                                        max_slots=2),
                           scheduler_config=SchedulerConfig(**_sched(**kw)),
                           device="cpu")
    rids = _submit_all(eng, workload)
    eng.run()
    return [eng.output_of(r) for r in rids]


def _placements(rec, rids):
    """(replica, reason, hit_pages) of each rid's routed event."""
    out = []
    for rid in rids:
        ev = [e for e in rec.by_category("fabric")
              if e.name == "routed" and e.rid == rid]
        assert ev, f"no routed event for rid {rid}"
        a = dict(ev[-1].attrs)
        out.append((a["replica"], a["reason"], a["hit_pages"]))
    return out


def _both_placements(t, j, trids, jrids):
    got = _placements(tobs.default_recorder(), trids)
    want = _placements(jobs.default_recorder(), jrids)
    assert got == want
    return got


# ------------------------------------------------------------- routing --

class TestRouting:
    def test_placement_deterministic(self, lms):
        wl = _workload(n=8, seed=3)
        placements = []
        for _ in range(2):
            t, j = _fabrics(lms, replicas=3)
            trids = _submit_all(t, wl)
            jrids = _submit_all(j, wl, jax_side=True)
            placements.append([t.replica_of(r) for r in trids])
            assert placements[-1] == [j.replica_of(r) for r in jrids]
            _both_placements(t, j, trids, jrids)
            t.run()
            j.run()
            assert [t.output_of(r) for r in trids] == \
                [j.output_of(r) for r in jrids]
        assert placements[0] == placements[1]
        assert len(set(placements[0])) > 1

    def test_affinity_follows_prefix_holder(self, lms):
        prefix = np.random.default_rng(1).integers(
            0, VOCAB, size=32).tolist()            # 4 full pages
        t, j = _fabrics(lms, replicas=2, spill=0)
        warm = (t.submit(prefix + [1, 2], 4), j.submit(prefix + [1, 2], 4))
        holder = t.replica_of(warm[0])
        assert holder == j.replica_of(warm[1])
        t.run()
        j.run()
        fol = (t.submit(prefix + [9, 8, 7], 4),
               j.submit(prefix + [9, 8, 7], 4))
        (rep, reason, hit), = _both_placements(t, j, [fol[0]], [fol[1]])
        assert rep == holder and reason == "affinity" and hit >= 4
        t.run()
        j.run()
        assert t.output_of(fol[0]) == j.output_of(fol[1])

    def test_spill_relieves_hot_holder(self, lms):
        prefix = np.random.default_rng(2).integers(
            0, VOCAB, size=32).tolist()
        t, j = _fabrics(lms, replicas=2, spill=1)
        warm = (t.submit(prefix + [1], 4), j.submit(prefix + [1], 4))
        holder = t.replica_of(warm[0])
        t.run()
        j.run()
        trids = [t.submit(prefix + [k + 2], 4) for k in range(3)]
        jrids = [j.submit(prefix + [k + 2], 4) for k in range(3)]
        got = _both_placements(t, j, trids, jrids)
        reasons = [g[1] for g in got]
        assert reasons[0] == "affinity" and got[0][0] == holder
        assert "spill" in reasons
        assert got[reasons.index("spill")][0] == 1 - holder
        t.run()
        j.run()

        t, j = _fabrics(lms, replicas=2, spill=0)
        warm = t.submit(prefix + [1], 4)
        j.submit(prefix + [1], 4)
        h0 = t.replica_of(warm)
        t.run()
        j.run()
        trids = [t.submit(prefix + [k + 2], 4) for k in range(4)]
        jrids = [j.submit(prefix + [k + 2], 4) for k in range(4)]
        _both_placements(t, j, trids, jrids)
        assert all(t.replica_of(r) == h0 for r in trids)
        t.run()

    def test_no_prefix_routes_by_load(self, lms):
        t, j = _fabrics(lms, replicas=2)
        trids = [t.submit([3 + i, 4, 5], 4) for i in range(4)]
        jrids = [j.submit([3 + i, 4, 5], 4) for i in range(4)]
        got = _both_placements(t, j, trids, jrids)
        assert [g[0] for g in got] == [0, 1, 0, 1]
        assert all(g[1] == "load" for g in got)
        t.run()


# ---------------------------------------------------- kill relocation --

STAGES = ("queued", "mid_chunk", "mid_decode", "mid_verify")


def _stage_hit(eng, stage):
    reqs = list(eng.scheduler.requests.values())
    if stage == "queued":
        return any(r.state == "waiting" for r in reqs)
    if stage == "mid_chunk":
        return any(r.state == "prefill" and 0 < r.prefill_pos
                   < len(r.kv_tokens()) for r in reqs)
    if stage == "mid_decode":
        return any(r.state == "running" and 0 < len(r.output)
                   < r.max_new_tokens for r in reqs)
    return eng.scheduler.stats["n_spec_accepted"] > 0


def _kill_at(fab, stage, victim=1):
    for _ in range(400):
        if _stage_hit(fab.replicas[victim], stage):
            return fab.kill_replica(victim)
        if not fab.has_work:
            break
        fab.step()
    raise AssertionError(f"workload drained before stage {stage}")


class TestKillReplay:
    @pytest.mark.parametrize("stage", STAGES)
    def test_kill_bit_exact_at_stage(self, lms, stage):
        wl = _workload(n=6, seed=4)
        expect = _baseline(lms, wl)
        t, j = _fabrics(lms, replicas=2)
        trids = _submit_all(t, wl)
        jrids = _submit_all(j, wl, jax_side=True)
        moved = _kill_at(t, stage)
        assert moved == _kill_at(j, stage) >= 1
        t.run()
        j.run()
        got = [t.output_of(r) for r in trids]
        assert got == expect
        assert got == [j.output_of(r) for r in jrids]
        migrated = [r for r in trids if t.request_summary(r)["migrated"]]
        assert len(migrated) == moved == t.migrations
        assert t.pool_restored()
        t.check_invariants()

    def test_kill_bit_exact_with_async_pipeline(self, lms):
        wl = _workload(n=6, seed=12)
        expect = _baseline(lms, wl, async_depth=1)
        t, j = _fabrics(lms, replicas=2, async_depth=1)
        trids = _submit_all(t, wl)
        jrids = _submit_all(j, wl, jax_side=True)
        _kill_at(t, "mid_decode")
        _kill_at(j, "mid_decode")
        t.run()
        j.run()
        got = [t.output_of(r) for r in trids]
        assert got == expect == [j.output_of(r) for r in jrids]
        assert t.pool_restored()

    def test_drain_replica_parity(self, lms):
        wl = _workload(n=6, seed=8)
        expect = _baseline(lms, wl)
        t, j = _fabrics(lms, replicas=2)
        trids = _submit_all(t, wl)
        jrids = _submit_all(j, wl, jax_side=True)
        for _ in range(3):
            t.step()
            j.step()
        assert t.drain_replica(0) == j.drain_replica(0)
        t.run()
        j.run()
        got = [t.output_of(r) for r in trids]
        assert got == expect == [j.output_of(r) for r in jrids]
        assert t.pool_restored()

    def test_single_replica_replays_onto_respawn(self, lms):
        wl = _workload(n=4, seed=6)
        expect = _baseline(lms, wl)
        t, j = _fabrics(lms, replicas=1)
        trids = _submit_all(t, wl)
        jrids = _submit_all(j, wl, jax_side=True)
        for _ in range(4):
            t.step()
            j.step()
        assert t.kill_replica(0) == j.kill_replica(0)
        t.run()
        j.run()
        got = [t.output_of(r) for r in trids]
        assert got == expect == [j.output_of(r) for r in jrids]
        assert t.pool_restored()

    def test_disaggregated_prefill_kill(self, lms):
        wl = _workload(n=5, seed=9)
        expect = _baseline(lms, wl)
        t, j = _fabrics(lms, replicas=2, roles="disaggregated")
        trids = _submit_all(t, wl)
        jrids = _submit_all(j, wl, jax_side=True)
        t.step()
        j.step()
        assert t.kill_replica(0) == j.kill_replica(0)
        t.run()
        j.run()
        got = [t.output_of(r) for r in trids]
        assert got == expect == [j.output_of(r) for r in jrids]
        assert t.pool_restored()

    def test_killed_replica_releases_its_memory(self, lms):
        """A killed replica's pools are dropped at once (``close``): the
        corpse holds no KV pool, no graph and no pinned ring."""
        wl = _workload(n=4, seed=2)
        t, _ = _fabrics(lms, replicas=2)
        _submit_all(t, wl)
        for _ in range(3):
            t.step()
        victim = t.replicas[1]
        t.kill_replica(1)
        assert victim.cache.k_pool is None and victim.cache.v_pool is None
        assert not victim._graphs and not victim._ring
        assert t.replicas[1] is not victim
        t.run()
        assert t.pool_restored()


# ------------------------------------------------------ disaggregation --

class TestDisaggregation:
    @pytest.mark.parametrize("async_depth", [0, 1])
    def test_parity_and_handoff(self, lms, async_depth):
        wl = _workload(n=6, seed=11)
        expect = _baseline(lms, wl, async_depth=async_depth)
        t, j = _fabrics(lms, replicas=3, roles="disaggregated",
                        async_depth=async_depth)
        trids = _submit_all(t, wl)
        jrids = _submit_all(j, wl, jax_side=True)
        t.run()
        j.run()
        got = [t.output_of(r) for r in trids]
        assert got == expect == [j.output_of(r) for r in jrids]
        assert t.handoff_pages == j.handoff_pages > 0
        s = t.summary()
        assert s["roles"] == ["prefill", "decode", "decode"]
        assert s["store_entries"] == j.summary()["store_entries"] > 0
        assert s["pending_handoffs"] == 0
        for r, jr in zip(trids, jrids):
            sm = t.request_summary(r)
            assert sm["fabric_rid"] == r
            assert sm["replica"] == j.request_summary(jr)["replica"]
            assert sm["replica"] in (1, 2)

    def test_cancel_before_handoff(self, lms):
        t, _ = _fabrics(lms, replicas=2, roles="disaggregated")
        rid = t.submit([5] * 20, 10)
        other = t.submit([7] * 20, 6)
        assert t.cancel(rid)
        t.run()
        req = t.find_request(rid)
        assert req.state == "finished"
        assert req.finish_reason == "cancelled"
        assert t.replica_of(rid) == 0
        assert t.summary()["pending_handoffs"] == 0
        assert len(t.output_of(other)) == 6

    def test_handoff_backpressure_retries(self, lms):
        wl = [([9, 8, 7] * 4, 6, None)]
        expect = _baseline(lms, wl)
        t, _ = _fabrics(lms, replicas=2, roles="disaggregated")
        deng = t.replicas[1]
        open_cfg = deng.scheduler.config
        deng.scheduler.config = dataclasses.replace(open_cfg, max_queue=0)
        rid = t.submit(*wl[0][:2])
        for _ in range(200):
            if t._handoff_retry or not t.has_work:
                break
            t.step()
        assert t._handoff_retry, "handoff never hit backpressure"
        deng.scheduler.config = open_cfg
        t.run()
        assert t.output_of(rid) == expect[0]
        assert t.find_request(rid).finish_reason == "max_new_tokens"


# --------------------------------------------------------------- chaos --

class TestChaos:
    def test_replica_kill_chaos_clean(self, lms, injectors):
        tinj, jinj = injectors(cancel_rate=0.08, malformed_rate=0.1,
                               replica_kill=1, replica_kill_step=6, seed=17)
        t, j = _fabrics(lms, replicas=2)
        report = run_chaos(t, n_requests=18, vocab=VOCAB, seed=5,
                           injector=tinj)
        for key in ("drained", "all_terminal", "truthful_reasons",
                    "free_pages_restored", "invariants_ok"):
            assert report[key], (key, report)
        assert report["malformed_leaks"] == 0, report
        assert tinj.counts.get("replica_kill", 0) == 1
        assert report["migrated"] == t.migrations
        t.check_invariants()
        # the same workload and injections as the JAX harness; what then
        # happens to each request depends on its wall-clock deadlines,
        # which the two backends meet at different speeds
        jreport = jrun_chaos(j, n_requests=18, vocab=VOCAB, seed=5,
                             injector=jinj)
        for key in ("submitted", "malformed_attempts"):
            assert report[key] == jreport[key], key
        assert jinj.counts.get("replica_kill", 0) == 1


# ----------------------------------------------------------- metrics --

class TestMetrics:
    def test_families_export_at_zero(self, lms, tmp_path):
        prev = tobs.set_default_registry(tobs.Registry())
        tobs.enable()
        try:
            _fabrics(lms, replicas=2)
            fams = tobs.fabric_metrics()
            assert fams["replicas"].value == 2
            for i in range(2):
                for reason in ROUTE_REASONS:
                    assert fams["routed"].labels(
                        replica=str(i), reason=reason).value == 0
            for key in ("hit_pages", "migrations", "handoff_pages"):
                assert fams[key].value == 0
            out = str(tmp_path / "fabric.prom")
            tobs.write_prometheus(out)
            text = open(out).read()
            for fam in ("pd_fabric_replicas", "pd_fabric_routed_total",
                        "pd_fabric_prefix_hit_pages",
                        "pd_fabric_migrations_total",
                        "pd_fabric_handoff_pages_total"):
                assert fam in text, f"{fam} missing from export"
        finally:
            tobs.set_default_registry(prev)

    def test_routed_counters_track_placements(self, lms):
        """Counter deltas equal the routed events, replica and reason by
        replica and reason, and equal the JAX fabric's counters."""
        prev = (tobs.set_default_registry(tobs.Registry()),
                jobs.set_default_registry(jobs.Registry()))
        tobs.enable()
        try:
            t, j = _fabrics(lms, replicas=2)
            prefix = list(range(1, 17))
            for fab in (t, j):
                fab.submit(prefix + [1], 4)
                fab.run()
                for i in range(4):
                    fab.submit([3 + i, 4, 5], 4)
                fab.submit(prefix + [2, 3], 4)
            tf, jf = tobs.fabric_metrics(), jobs.fabric_metrics()
            for i in range(2):
                for r in ROUTE_REASONS:
                    assert tf["routed"].labels(replica=str(i), reason=r
                                               ).value == \
                        jf["routed"].labels(replica=str(i), reason=r).value
            total = sum(tf["routed"].labels(replica=str(i), reason=r).value
                        for i in range(2) for r in ROUTE_REASONS)
            assert total == 6
            assert tf["hit_pages"].value == jf["hit_pages"].value >= 2
            t.run()
        finally:
            tobs.set_default_registry(prev[0])
            jobs.set_default_registry(prev[1])


# ------------------------------------------------------------ config --

class TestConfig:
    def test_degrade_rules(self):
        assert FabricConfig(replicas=0).replicas == 1
        assert FabricConfig(spill=-3).spill == 0
        assert FabricConfig(roles="weird").roles == "colocated"
        assert FabricConfig(roles=" Disaggregated ",
                            replicas=2).roles == "disaggregated"
        assert FabricConfig(roles="disaggregated",
                            replicas=1).roles == "colocated"

    def test_defaults_are_the_policy_knobs(self):
        """The port's fabric defaults are its policy copy, pinned to the
        JAX package's ``shared_policy()`` in ``test_torch_isolation``;
        the JAX fabric's defaults agree."""
        c, jc = FabricConfig(), JFabricConfig()
        assert (c.replicas, c.spill, c.roles) == (
            policy.FABRIC_REPLICAS, policy.FABRIC_SPILL, policy.FABRIC_ROLES)
        assert (c.replicas, c.spill, c.roles, c.seed, c.trace) == (
            jc.replicas, jc.spill, jc.roles, jc.seed, jc.trace)

    def test_shared_weights_and_quant_resolution(self, lms):
        """The replicas share one model: with int8 weights and the int8
        matmul the fabric quantizes and lays out the weights once, and
        every replica serves those very tensors, its cache config
        aligned to the quant config."""
        _, tm = lms
        from paddle_tpu_torch.inference.llm.quant import QuantConfig
        q = QuantConfig(kv="int8", weights="int8", weight_matmul="int8",
                        scale_dtype="bfloat16")
        fab = ServingFabric(tm, FabricConfig(replicas=2),
                            cache_config=CacheConfig(**CACHE, max_slots=2),
                            scheduler_config=SchedulerConfig(**_sched()),
                            quant=q, device="cpu")
        a, b = fab.replicas
        assert a.model.params["l0.wqkv@qt"] is b.model.params["l0.wqkv@qt"]
        for eng in fab.replicas:
            cc = eng.cache.config
            assert (cc.kv_quant, cc.scale_dtype, cc.weight_quant,
                    cc.weight_matmul) == ("int8", "bfloat16", "int8",
                                          "int8")
        assert a.cache.k_pool is not b.cache.k_pool
        rid = fab.submit(list(range(1, 20)), 5)
        fab.run()
        assert len(fab.output_of(rid)) == 5

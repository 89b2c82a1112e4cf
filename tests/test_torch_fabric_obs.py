"""The port's fabric observability plane against the JAX package's.

The cases of ``tests/test_fabric_obs.py``, each run on the port's
fabric, and where the two can be compared, beside the JAX fabric on the
same weights, configs and submissions:

- **one track per request** in ``merge_traces``, a disaggregated request
  killed mid-decode included (submit -> route -> prefill on r0 ->
  handoff -> decode -> migrate -> finished, hops unique, the fabric
  spans' hops in timestamp order), and the trace ids equal to the JAX
  fabric's (they are a pure function of submission order and content);
- **tracing off** emits no trace event and leaves tokens bit-exact;
- **exact merged percentiles**: ``merge_slo_digests`` equals numpy over
  the concatenated samples (rel 1e-9), and so does the fabric view;
- **the merged view**: the ``replica="all"`` rows equal the per-replica
  sums and the tokens served, stay monotonic across a kill, and the
  ``pd_fabric_*`` router families (placements by replica and reason, hit
  pages, handoff pages) equal the JAX fabric's;
- **burn-rate alerts**: an idle fabric never fires, objectives at 0 are
  inert, an injected slow step fires and healing clears, at the same
  fabric steps as the JAX fabric under the same injection (the windows
  and thresholds chosen so that every faulted inter-token gap violates
  the objective and every healthy one meets it on either backend), and
  a firing alert raises the burning replicas' brownout pressure.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu import observability as jobs  # noqa: E402
from paddle_tpu.inference.llm import (  # noqa: E402
    CacheConfig as JCacheConfig, FabricConfig as JFabricConfig,
    FaultConfig as JFaultConfig, FaultInjector as JFaultInjector, JaxLM,
    SamplingParams as JSP, SchedulerConfig as JSchedulerConfig,
    ServingFabric as JFabric, set_default_injector as jset_injector)
from paddle_tpu.observability.alerts import (  # noqa: E402
    AlertConfig as JAlertConfig, SLOAlerts as JSLOAlerts)
import paddle_tpu_torch.observability as obs  # noqa: E402
from paddle_tpu_torch.inference.llm import (  # noqa: E402
    CacheConfig, FabricConfig, FaultConfig, FaultInjector, SamplingParams,
    SchedulerConfig, ServingFabric, TorchLM, set_default_injector)
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
def fresh_obs():
    """Fresh default registries, recorders and SLO digests on both sides:
    fabrics bind all three at construction."""
    prev = [(o.set_default_registry(o.Registry()),
             o.set_default_recorder(o.FlightRecorder()),
             o.set_default_slo_digest(o.SLODigest())) for o in (obs, jobs)]
    obs.enable()
    jobs.enable()
    try:
        yield
    finally:
        for o, (reg, rec, slo) in zip((obs, jobs), prev):
            o.set_default_registry(reg)
            o.set_default_recorder(rec)
            o.set_default_slo_digest(slo)


@pytest.fixture
def injectors():
    saved = []

    def _install(**rates):
        t = FaultInjector(FaultConfig(**rates))
        j = JFaultInjector(JFaultConfig(**rates))
        saved.append((set_default_injector(t), jset_injector(j)))
        return t, j

    yield _install
    while saved:
        t, j = saved.pop()
        set_default_injector(t)
        jset_injector(j)


CACHE = dict(num_layers=2, num_heads=2, head_dim=16, num_pages=64,
             page_size=8, max_seq_len=128, prefix_cache=True, swap_pages=64,
             max_slots=2)
SCHED = dict(max_slots=2, min_bucket=8, max_seq_len=128, chunk_tokens=8,
             spec_tokens=3, priority_classes=3, max_queue=32)


def _fabric(lms, replicas=2, roles="colocated", trace=True):
    _, tm = lms
    return ServingFabric(tm, FabricConfig(replicas=replicas, roles=roles,
                                          trace=trace),
                         cache_config=CacheConfig(**CACHE),
                         scheduler_config=SchedulerConfig(**SCHED),
                         device="cpu")


def _jfabric(lms, replicas=2, roles="colocated", trace=True):
    jm, _ = lms
    return JFabric(jm, JFabricConfig(replicas=replicas, roles=roles,
                                     trace=trace),
                   cache_config=JCacheConfig(**CACHE),
                   scheduler_config=JSchedulerConfig(**SCHED))


def _workload(n=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        block = rng.integers(0, VOCAB, size=6).tolist()
        prompt = (block * 5)[:18 + int(rng.integers(0, 10))]
        sp = None if i % 2 == 0 else dict(temperature=0.8, top_k=8,
                                         seed=100 + i)
        out.append((prompt, 8 + i % 4, sp))
    return out


def _submit(fab, wl, jax_side=False, mnt=None):
    cls = JSP if jax_side else SamplingParams
    return [fab.submit(p, mnt or m, None if sp is None else cls(**sp))
            for p, m, sp in wl]


def _run(fab, budget=400):
    for _ in range(budget):
        if fab.step() == "idle":
            return
    raise AssertionError("fabric did not go idle")


def _outputs(fab, rids):
    return [list(fab.find_request(r).output) for r in rids]


def _tracks(trace_json):
    evs = [e for e in trace_json["traceEvents"] if e.get("ph") != "M"]
    out = {}
    for e in sorted(evs, key=lambda e: e["ts"]):
        out.setdefault(e["tid"], []).append(e["name"])
    return out


# ------------------------------------------------ cross-replica tracing --

class TestMergedTrace:
    def test_one_track_per_request(self, lms, fresh_obs):
        fab = _fabric(lms)
        rids = _submit(fab, _workload(4))
        _run(fab)
        tr = obs.merge_traces(recorder=fab._rec)
        json.loads(json.dumps(tr))
        tracks = _tracks(tr)
        assert len(tracks) == len(rids)
        for names in tracks.values():
            assert names[0] == "submit"
            assert "route" in names
            assert any(n.startswith("queued@r") for n in names)
            assert any(n.startswith("finished@r") for n in names)

    def test_kill_mid_decode_single_track(self, lms, fresh_obs):
        fab = _fabric(lms, replicas=3, roles="disaggregated")
        rids = _submit(fab, _workload(3, seed=3), mnt=10)
        for _ in range(6):
            fab.step()
        victims = [i for i in fab._decode_idxs()
                   if fab.replicas[i].scheduler.has_work]
        assert victims, "no decode replica had work to kill"
        fab.kill_replica(victims[0])
        _run(fab)
        tr = obs.merge_traces(recorder=fab._rec)
        json.loads(json.dumps(tr))
        tracks = _tracks(tr)
        assert len(tracks) == len(rids)
        flat = [n for names in tracks.values() for n in names]
        assert "handoff" in flat and "migrate" in flat
        migrated = [names for names in tracks.values()
                    if "migrate" in names]
        for names in migrated:
            assert names[0] == "submit"
            assert any(n.startswith("queued@r0") or n == "prefill@r0"
                       for n in names)
            assert any(n.startswith("finished@r") for n in names)
        spans = ("submit", "route", "handoff", "migrate")
        for tid in tracks:
            evs = [e for e in tr["traceEvents"]
                   if e.get("ph") != "M" and e["tid"] == tid]
            hops = [e["args"]["hop"] for e in evs
                    if "hop" in e.get("args", {})]
            assert len(hops) == len(set(hops))
            span_hops = [e["args"]["hop"] for e in
                         sorted(evs, key=lambda e: e["ts"])
                         if e["name"] in spans]
            assert span_hops == sorted(span_hops)

    def test_trace_ids_deterministic_and_equal_to_jax(self, lms, fresh_obs):
        fab, jfab = _fabric(lms), _jfabric(lms)
        wl = _workload(3)
        tids = [fab._tracer.trace_of(r) for r in _submit(fab, wl)]
        jtids = [jfab._tracer.trace_of(r)
                 for r in _submit(jfab, wl, jax_side=True)]
        assert tids == jtids and len(set(tids)) == 3
        _run(fab)
        again = _fabric(lms)
        assert [again._tracer.trace_of(r) for r in _submit(again, wl)] \
            == tids


class TestTraceOff:
    def test_disabled_emits_zero_trace_events_and_is_bit_exact(
            self, lms, fresh_obs):
        wl = _workload(4, seed=5)
        fab_on = _fabric(lms, trace=True)
        rids_on = _submit(fab_on, wl)
        _run(fab_on)
        out_on = _outputs(fab_on, rids_on)
        prev = obs.set_default_recorder(obs.FlightRecorder())
        try:
            fab_off = _fabric(lms, trace=False)
            rids_off = _submit(fab_off, wl)
            _run(fab_off)
            out_off = _outputs(fab_off, rids_off)
            stamped = [ev for ev in fab_off._rec.snapshot()
                       if ev.attr("trace") is not None or ev.cat == "trace"]
            assert stamped == []
            tr = obs.merge_traces(recorder=fab_off._rec)
            assert [e for e in tr["traceEvents"] if e.get("ph") != "M"] \
                == []
        finally:
            obs.set_default_recorder(prev)
        assert out_on == out_off


# ------------------------------------------------------ merged digests --

class TestMergedSLO:
    def test_merge_equals_numpy_over_concatenation(self):
        rng = np.random.default_rng(11)
        digests, all_samples = [], {}
        for rep in range(3):
            d = obs.SLODigest(capacity=512)
            for metric in ("ttft", "itl"):
                vals = rng.gamma(2.0, 0.05, size=40 + 20 * rep)
                for v in vals:
                    d.observe(metric, "default", 0, float(v))
                all_samples.setdefault(metric, []).extend(vals)
            digests.append(d)
        merged = obs.merge_slo_digests(digests)
        jmerged = jobs.merge_slo_digests([
            _jax_digest(d) for d in digests])
        for metric, vals in all_samples.items():
            for q in (0.5, 0.9, 0.99):
                got = merged.quantile(metric, "default", 0, q)
                want = float(np.quantile(np.asarray(vals), q))
                assert got == pytest.approx(want, rel=1e-9), (metric, q)
                assert got == jmerged.quantile(metric, "default", 0, q)

    def test_fabric_view_merged_slo_exact(self, lms, fresh_obs):
        fab = _fabric(lms)
        _submit(fab, _workload(4))
        _run(fab)
        concat = []
        for eng in fab.replicas:
            for (m, t, pr), qd in eng.scheduler.slo_digest.items():
                if m == "itl" and t == "default":
                    concat.extend(qd.values())
        got = fab.obs_view.merged_slo().quantile("itl", "default", 0, 0.5)
        assert got == pytest.approx(float(np.quantile(np.asarray(concat),
                                                      0.5)), rel=1e-9)


def _jax_digest(d):
    """The same samples observed into a JAX ``SLODigest``."""
    j = jobs.SLODigest(capacity=d.capacity)
    for (metric, tenant, prio), qd in d.items():
        for v in qd.values():
            j.observe(metric, tenant, prio, v)
    return j


# ---------------------------------------------------------- the view --

def _view_fams(fab):
    fab.obs_view.refresh()
    return {f.name: f for f in fab.obs_view.registry.collect()}


class TestRegistryView:
    def test_view_sums_equal_per_replica_sums(self, lms, fresh_obs):
        fab = _fabric(lms)
        rids = _submit(fab, _workload(5))
        _run(fab)
        fams = _view_fams(fab)
        for name in ("pd_serving_tokens_generated_total",
                     "pd_serving_requests_finished_total"):
            per_rep = {lv[-1]: c.value for lv, c in fams[name].samples()}
            want = sum(eng.obs_registry._families[name].total()
                       for eng in fab.replicas)
            assert per_rep["all"] == want
            assert sum(v for k, v in per_rep.items() if k != "all") == want
        tokens = sum(len(fab.find_request(r).output) for r in rids)
        assert fams["pd_serving_tokens_generated_total"].labels(
            replica="all").value == tokens

    def test_view_monotonic_across_kill(self, lms, fresh_obs):
        fab = _fabric(lms)
        rids = _submit(fab, _workload(4))
        for _ in range(4):
            fab.step()
        before = _view_fams(fab)["pd_serving_tokens_generated_total"] \
            .labels(replica="all").value
        fab.kill_replica(1)
        _run(fab)
        after = _view_fams(fab)["pd_serving_tokens_generated_total"] \
            .labels(replica="all").value
        assert after >= before
        total = sum(len(fab.find_request(r).output) for r in rids)
        assert fab.obs_view.tenant_table()["default"]["tokens"] == total

    def test_router_families_equal_jax(self, lms, fresh_obs):
        """The fabric-level families in the merged view (placements by
        replica and reason, hit pages, handoff pages, replicas) equal
        the JAX fabric's, and the per-replica token rows too."""
        wl = _workload(5, seed=7)
        fab, jfab = (_fabric(lms, replicas=3, roles="disaggregated"),
                     _jfabric(lms, replicas=3, roles="disaggregated"))
        _submit(fab, wl)
        _submit(jfab, wl, jax_side=True)
        _run(fab)
        _run(jfab)
        t = _view_fams(fab)
        jfab.obs_view.refresh()
        j = {f.name: f for f in jfab.obs_view.registry.collect()}
        for name in ("pd_fabric_routed_total", "pd_fabric_prefix_hit_pages",
                     "pd_fabric_handoff_pages_total", "pd_fabric_replicas",
                     "pd_fabric_migrations_total",
                     "pd_serving_tokens_generated_total",
                     "pd_serving_requests_finished_total"):
            got = {lv: c.value for lv, c in t[name].samples()}
            want = {lv: c.value for lv, c in j[name].samples()}
            assert got == want, name
        assert fab.obs_view.tenant_table() == jfab.obs_view.tenant_table()

    def test_hop_histograms_and_tenant_gauges_export(self, lms, fresh_obs):
        fab = _fabric(lms, roles="disaggregated")
        _submit(fab, _workload(3))
        _run(fab)
        fab.obs_view.refresh()
        text = obs.to_prometheus_text(fab.obs_view.registry)
        for fam in ("pd_fabric_route_seconds", "pd_fabric_handoff_seconds",
                    "pd_fabric_tenant_tokens", "pd_slo_burn_rate"):
            assert fam in text, f"{fam} missing from merged export"
        assert fab._obs["route_s"].count >= 3
        assert fab._obs["handoff_s"].count >= 1


# ------------------------------------------------------------- alerts --

# every faulted step sleeps FAULT_MS on each replica, so a faulted
# inter-token gap is >= 2 * FAULT_MS; the objective sits at FAULT_MS,
# far above a healthy step of the tiny model on either backend
FAULT_MS = 250
ALERTS = dict(itl_ms=FAULT_MS, fast_window=8, slow_window=32, eval_every=4,
              up_after=2, down_after=2, min_samples=4)


def _alerting(fab, cfg_cls, alerts_cls):
    fab.alerts = alerts_cls(fab, cfg_cls(**ALERTS))
    fab.obs_view._alerts = None
    return fab


def _alert_story(fab, inj, jax_side):
    """(fabric step of the first fire, of the first clear, burning set
    and brownout pressure flags at the fire) under a slow-step fault
    healed at the fire, with fresh traffic after it (as the JAX test
    drives it: two requests every four steps)."""
    fired = cleared = burning = pressure = None
    _submit(fab, _workload(8, seed=2), jax_side, mnt=8)
    for step in range(1, 65):
        fab.step()
        if fab.alerts.fires:
            fired = step
            burning = set(fab.alerts.burning)
            pressure = [e.brownout.alert_pressure for e in fab.replicas]
            inj.config = type(inj.config)(seed=11)     # heal
            break
    else:
        return fired, cleared, burning, pressure
    for i in range(120):
        _submit(fab, _workload(2, seed=20 + i), jax_side, mnt=12)
        for _ in range(4):
            fab.step()
            step += 1
        if fab.alerts.clears:
            cleared = step
            break
    return fired, cleared, burning, pressure


class TestAlerts:
    def test_idle_fabric_never_fires(self, lms, fresh_obs, monkeypatch):
        monkeypatch.setenv("PD_SLO_ITL_MS", "50")
        fab = _fabric(lms)
        assert fab.alerts.enabled
        for _ in range(64):
            fab.step()
        assert fab.alerts.fires == 0
        assert fab.alerts.active() == [] and fab.alerts.burning == set()

    def test_disabled_is_inert(self, lms, fresh_obs):
        fab = _fabric(lms)
        assert not fab.alerts.enabled
        _submit(fab, _workload(3))
        _run(fab)
        assert fab.alerts.evaluations == 0
        assert [ev for ev in fab._rec.snapshot() if ev.cat == "alert"] == []
        assert not any(e.brownout.alert_pressure for e in fab.replicas)

    def test_fire_then_clear_at_the_jax_steps(self, lms, fresh_obs,
                                              injectors):
        tinj, jinj = injectors(delay_rate=1.0, delay_ms=FAULT_MS, seed=11)
        fab = _alerting(_fabric(lms), obs.AlertConfig, obs.SLOAlerts)
        jfab = _alerting(_jfabric(lms), JAlertConfig, JSLOAlerts)
        got = _alert_story(fab, tinj, False)
        want = _alert_story(jfab, jinj, True)
        fired, cleared, burning, pressure = got
        assert fired is not None, "alert never fired under the fault"
        assert cleared is not None, "alert never cleared after healing"
        assert got == want
        assert burning and all(pressure[i] for i in burning)
        assert fab.alerts.active() == [] and fab.alerts.burning == set()
        assert not any(e.brownout.alert_pressure for e in fab.replicas)
        evs = [ev.name for ev in fab._rec.snapshot() if ev.cat == "alert"]
        assert evs.count("fire") == fab.alerts.fires
        assert evs.count("clear") == fab.alerts.clears

    def test_burn_gauge_prebound_and_updates(self, lms, fresh_obs,
                                             monkeypatch):
        monkeypatch.setenv("PD_SLO_TTFT_MS", "5000")
        fab = _fabric(lms)
        assert "pd_slo_burn_rate" in obs.to_prometheus_text()
        _submit(fab, _workload(3))
        _run(fab)
        for _ in range(fab.alerts.config.eval_every):
            fab.step()
        assert fab.alerts.evaluations >= 1
        assert ("default", "0") in fab.alerts.burn_rates()

    def test_config_validation(self):
        with pytest.raises(ValueError):
            obs.AlertConfig(budget=0.0)
        with pytest.raises(ValueError):
            obs.AlertConfig(fast_window=8, slow_window=4)
        c, j = obs.AlertConfig(), JAlertConfig()
        assert c == type(c)(**{f: getattr(j, f)
                               for f in c.__dataclass_fields__})

"""The port's str/int/bytes serving bridge against the JAX package's.

``paddle_tpu_torch.inference.serving`` over a port engine or fabric, and
``paddle_tpu.inference.serving`` over a JAX engine or fabric, on the same
weights, configs and submissions:

- submit return codes: a ticket, -1 queue full, -2 malformed, -3
  overloaded (brownout shedding), with the same retry-after rule;
- ``engine_wait``/``fabric_wait`` bytes equal, tickets cancel to 1 then 0
  (unknown tickets 0), ``engine_stats`` equal;
- the JSON strings: request summaries with the JAX keys, the step
  profile's and cost summary's key sets (the per-graph ``captures`` in
  place of JAX's ``xla_costs``), ``engine_mesh`` equal to a meshless JAX
  engine's but for ``recovery_enabled`` (the port has no mesh to
  recover), ``fabric_summary`` and ``fabric_alerts`` equal;
- ``engine_drain``, ``fabric_drain_replica``, the watchdog handle, the
  Chrome-trace and merged-trace exports, the Prometheus text (the
  fabric's merged view included) and the ``/metrics`` endpoint;
- the helpers over saved artifacts (``create``, ``engine_create``,
  ``fabric_create``) and the native host's ``native_server_record_stats``
  raise ``NotImplementedError`` naming ROADMAP A.12.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.inference import serving as jserving  # noqa: E402
from paddle_tpu.inference.llm import (  # noqa: E402
    CacheConfig as JCacheConfig, FabricConfig as JFabricConfig,
    GenerationEngine as JEngine, JaxLM, SchedulerConfig as JSchedulerConfig,
    ServingFabric as JFabric)
from paddle_tpu_torch.inference import serving  # noqa: E402
from paddle_tpu_torch.inference.llm import (  # noqa: E402
    CacheConfig, FabricConfig, GenerationEngine, SchedulerConfig,
    ServingFabric, TorchLM)
from paddle_tpu_torch.inference.llm.model import params_from_jax  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

VOCAB = 64
CACHE = dict(num_layers=2, num_heads=2, head_dim=16, num_pages=64,
             page_size=8, max_seq_len=128, prefix_cache=True, swap_pages=64,
             max_slots=2)
SCHED = dict(max_slots=2, min_bucket=8, max_seq_len=128, chunk_tokens=8,
             priority_classes=3, max_queue=4)


@pytest.fixture(scope="module")
def lms():
    jm = JaxLM.tiny(vocab=VOCAB, d_model=32, num_layers=2, num_heads=2,
                    head_dim=16, max_seq_len=128, seed=7)
    tm = TorchLM(jm.spec, params_from_jax(
        {k: np.asarray(v) for k, v in jm.params.items()}, "cpu"),
        device="cpu")
    return jm, tm


def _engines(lms, **sched):
    jm, tm = lms
    s = dict(SCHED, **sched)
    return (GenerationEngine(tm, cache_config=CacheConfig(**CACHE),
                             scheduler_config=SchedulerConfig(**s),
                             device="cpu"),
            JEngine(jm, cache_config=JCacheConfig(**CACHE),
                    scheduler_config=JSchedulerConfig(**s)))


def _fabrics(lms, roles="colocated"):
    jm, tm = lms
    return (ServingFabric(tm, FabricConfig(replicas=2, roles=roles),
                          cache_config=CacheConfig(**CACHE),
                          scheduler_config=SchedulerConfig(**SCHED),
                          device="cpu"),
            JFabric(jm, JFabricConfig(replicas=2, roles=roles),
                    cache_config=JCacheConfig(**CACHE),
                    scheduler_config=JSchedulerConfig(**SCHED)))


def _tok(prompt):
    return np.asarray(prompt, np.int32).tobytes()


PROMPTS = [list(range(3, 21)), [5, 9, 2, 7] * 3, list(range(30, 41))]


def test_engine_submit_codes_equal(lms):
    """Tickets, then -2 for malformed submits, -1 once the queue is
    full, and -3 while brownout sheds the lowest class, on both
    sides."""
    got = {}
    for side, (mod, eng) in zip(("port", "jax"),
                                zip((serving, jserving), _engines(lms))):
        codes = [mod.engine_submit(eng, _tok(p), 4) for p in PROMPTS]
        assert all(c >= 0 for c in codes)
        codes = [int(c >= 0) for c in codes]
        codes.append(mod.engine_submit(eng, _tok([]), 4))        # empty
        codes.append(mod.engine_submit(eng, _tok([1, 2]), 0))    # 0 tokens
        codes.append(mod.engine_submit(eng, _tok([1, 2]), 4,
                                       priority=7))              # class
        codes.append(mod.engine_submit(eng, _tok([1, 2]), 500))  # too long
        codes += [mod.engine_submit(eng, _tok([4, 4]), 2) for _ in range(3)]
        codes = [min(c, 1) for c in codes]
        assert mod.engine_retry_after_ms(eng) == 0
        eng.brownout.level = 4
        eng.brownout._apply()
        codes.append(mod.engine_submit(eng, _tok([1, 2, 3]), 2,
                                       priority=2))
        codes.append(mod.engine_brownout_level(eng))
        assert mod.engine_retry_after_ms(eng) > 0
        got[side] = codes
    assert got["port"] == got["jax"]
    assert got["port"][3:7] == [-2, -2, -2, -2]
    assert -1 in got["port"] and got["port"][-2:] == [-3, 4]


def test_engine_wait_cancel_stats_and_json(lms):
    (t, j) = _engines(lms, max_queue=32)
    out = {}
    for side, mod, eng in (("port", serving, t), ("jax", jserving, j)):
        tickets = [mod.engine_submit(eng, _tok(p), 6) for p in PROMPTS]
        waited = [np.frombuffer(mod.engine_wait(eng, tk), np.int32).tolist()
                  for tk in tickets[:2]]
        live = mod.engine_submit(eng, _tok([8, 8, 8, 8]), 6)
        cancels = [mod.engine_cancel(eng, live),
                   mod.engine_cancel(eng, live),
                   mod.engine_cancel(eng, 10 ** 12)]
        with pytest.raises(ValueError):
            mod.engine_wait(eng, 10 ** 12)
        waited.append(np.frombuffer(mod.engine_wait(eng, tickets[2]),
                                    np.int32).tolist())
        summary = json.loads(mod.engine_request_summary(eng, tickets[0]))
        prof = json.loads(mod.engine_step_profile(eng, last=4))
        cost = json.loads(mod.engine_cost_summary(eng))
        out[side] = dict(waited=waited, cancels=cancels,
                         stats=mod.engine_stats(eng)[:2],
                         summary_keys=set(summary),
                         summary_tokens=summary["tokens_generated"],
                         prof_keys=(set(prof), set(prof["async"])),
                         n_records=len(prof["records"]),
                         cost_keys=set(cost) - {"captures", "xla_costs"},
                         cost_on=cost["enabled"],
                         drained=mod.engine_drain(eng),
                         mesh=json.loads(mod.engine_mesh(eng)))
        # the per-graph captures: the JAX ledger's XLA cost analyses,
        # the port's CUDA graph captures
        assert ("captures" if side == "port" else "xla_costs") in cost
        # a meshless JAX engine still holds an (inert) elastic-recovery
        # controller; the port has no mesh to recover
        out[side]["mesh"].pop("recovery_enabled")
    assert out["port"] == out["jax"]
    assert out["port"]["cancels"] == [1, 0, 0]
    assert out["port"]["mesh"]["devices"] == 1


def test_engine_watchdog_and_exports(lms, tmp_path):
    t, _ = _engines(lms, max_queue=32)
    wd = serving.engine_watchdog(t, deadline_s=5.0,
                                 dump_path=str(tmp_path))
    try:
        tk = serving.engine_submit(t, _tok(PROMPTS[0]), 3)
        serving.engine_wait(t, tk)
        assert wd.status()["stalls_total"] == 0
    finally:
        wd.stop()
    path = serving.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.load(open(path))
    assert any(e.get("tid") == tk for e in trace["traceEvents"])
    text = serving.metrics_prometheus()
    assert "pd_serving_tokens_generated_total" in text
    slo = json.loads(serving.slo_percentiles())
    assert isinstance(slo, dict)
    port = serving.metrics_serve()
    try:
        assert port > 0 and serving.metrics_serve() == port
    finally:
        serving._metrics_server.close()
        serving._metrics_server = None


@pytest.fixture
def fresh_recorders():
    """Fresh flight recorders on both sides: a fabric's merged trace
    reads the recorder it was built on, which earlier tests of the same
    process would otherwise have filled."""
    from paddle_tpu import observability as jobs
    from paddle_tpu_torch import observability as tobs

    prev = (tobs.set_default_recorder(tobs.FlightRecorder()),
            jobs.set_default_recorder(jobs.FlightRecorder()))
    yield
    tobs.set_default_recorder(prev[0])
    jobs.set_default_recorder(prev[1])


def test_fabric_bridge_equal(lms, tmp_path, fresh_recorders):
    """Routed submits, waits, cancels, the drive loop, a drained replica,
    the summary and alert JSON: the port's bridge answers as the JAX
    bridge does over the same fabric."""
    out = {}
    for side, mod, fab in zip(("port", "jax"), (serving, jserving),
                              _fabrics(lms, roles="disaggregated")):
        t0 = mod.fabric_submit(fab, _tok(PROMPTS[0]), 4)
        t1 = mod.fabric_submit(fab, _tok(PROMPTS[1]), 5)
        bad = mod.fabric_submit(fab, _tok([]), 4)
        got0 = np.frombuffer(mod.fabric_wait(fab, t0), np.int32).tolist()
        live = mod.fabric_submit(fab, _tok(PROMPTS[2]), 8)
        cancels = [mod.fabric_cancel(fab, live), mod.fabric_cancel(fab, t0),
                   mod.fabric_cancel(fab, 10 ** 12)]
        with pytest.raises(ValueError):
            mod.fabric_wait(fab, 10 ** 12)
        steps = 0
        while mod.fabric_step(fab):
            steps += 1
        got1 = np.frombuffer(mod.fabric_wait(fab, t1), np.int32).tolist()
        moved = mod.fabric_drain_replica(fab, 1)
        summary = json.loads(mod.fabric_summary(fab))
        alerts = json.loads(mod.fabric_alerts(fab))
        text = mod.fabric_metrics_prometheus(fab)
        trace = json.load(open(mod.fabric_export_trace(
            fab, str(tmp_path / f"{side}.json"))))
        out[side] = dict(codes=[min(t0, 0), min(t1, 0), bad],
                         outputs=(got0, got1), cancels=cancels, moved=moved,
                         summary=summary, alerts=alerts,
                         fams=sorted({ln.split()[2] for ln in
                                      text.splitlines()
                                      if ln.startswith("# TYPE")
                                      and "pd_fabric" in ln}),
                         tracks=len({e["tid"] for e in trace["traceEvents"]
                                     if e.get("ph") != "M"}))
    assert out["port"] == out["jax"]
    assert out["port"]["codes"] == [0, 0, -2]
    assert out["port"]["cancels"] == [1, 0, 0]
    assert out["port"]["summary"]["handoff_pages"] > 0
    assert out["port"]["tracks"] == 3


@pytest.mark.parametrize("name,args", [
    ("create", ("prefix",)), ("engine_create", ("prefix",)),
    ("fabric_create", ("prefix",)),
    ("native_server_record_stats", (1, 1, 1, 0, 1))])
def test_artifact_and_native_helpers_wait_for_a12(name, args):
    assert name in serving.__all__ and name in jserving.__all__
    with pytest.raises(NotImplementedError, match="A.12"):
        getattr(serving, name)(*args)


# the helpers that drive a saved artifact's Predictor come with it (A.12)
PREDICTOR_HELPERS = ("input_names", "output_names", "set_input", "run",
                     "get_output")


def test_surface_covers_the_jax_bridge():
    """Every helper of the JAX bridge that takes an engine or a fabric
    exists in the port's, with the same parameter names; the Predictor's
    own helpers wait for it."""
    import inspect

    for name in jserving.__all__:
        if name in PREDICTOR_HELPERS:
            assert not hasattr(serving, name), name
            continue
        assert hasattr(serving, name), name
        assert list(inspect.signature(getattr(serving, name)).parameters) \
            == list(inspect.signature(getattr(jserving, name)).parameters), \
            name

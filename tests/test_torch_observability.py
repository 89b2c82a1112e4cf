"""The port's observability substrate against the JAX package's
(``paddle_tpu/observability``), on the CPU.

- Registry: the same sequence of counter, gauge and histogram
  operations (labelled families, seeded values) exports byte-identical
  Prometheus text and JSON from both packages.
- ``QuantileDigest`` and ``SLODigest``: equal percentiles (exact float
  equality: both interpolate over the same sorted window) and equal
  snapshots on the same seeded observations.
- Flight recorder: ring capacity and eviction, per-request and
  per-category views, and the Chrome trace of the same events equal to
  the JAX package's; the device trace of ``torch.profiler`` merged
  beside it.
- Spans (``record_function`` + histogram + recorder slice) and
  ``instrument_jit``'s first-signature counter; the metrics server on
  localhost; the watchdog's stall dump.
- The metric catalog: every serving and ledger family the port binds
  exists in the JAX catalog under the same name and type (the port's
  one addition, the fault boundary's retry counter, aside).
"""
import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu import observability as jobs  # noqa: E402
from paddle_tpu.observability import chrome_trace as jct  # noqa: E402
from paddle_tpu.observability import recorder as jrec  # noqa: E402
from paddle_tpu_torch import observability as tobs  # noqa: E402
from paddle_tpu_torch.observability import chrome_trace as tct  # noqa: E402
from paddle_tpu_torch.observability import recorder as trec  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401


def _drive_registry(obs, seed):
    """A fixed sequence of registry operations on a fresh registry."""
    rng = np.random.default_rng(seed)
    r = obs.Registry()
    c = r.counter("pd_test_requests_total", "requests by route",
                  labelnames=("route", "code"))
    g = r.gauge("pd_test_depth", "queue depth")
    h = r.histogram("pd_test_latency_seconds", "latency by phase",
                    labelnames=("phase",),
                    buckets=obs.log_buckets(1e-4, 10.0, 2.0))
    plain = r.histogram("pd_test_plain_seconds", "default buckets")
    for i in range(60):
        c.labels(route=["a", "b", "c"][i % 3],
                 code=str(200 + 100 * (i % 2))).inc(int(rng.integers(1, 4)))
        g.set(float(rng.integers(0, 50)))
        h.labels(phase=["plan", "pack"][i % 2]).observe(
            float(rng.lognormal(-6, 2)))
        plain.observe(float(rng.exponential(0.01)))
    g.inc(2.5)
    g.dec(1.0)
    r.counter("pd_test_escaped_total", 'help with "quotes" \\ and\nnewline',
              labelnames=("v",)).labels(v='x"y\\z\n').inc()
    return r


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_exports_are_byte_identical(seed):
    jr, tr = _drive_registry(jobs, seed), _drive_registry(tobs, seed)
    assert tobs.to_prometheus_text(tr) == jobs.to_prometheus_text(jr)
    assert json.dumps(tobs.to_json(tr), sort_keys=True) == \
        json.dumps(jobs.to_json(jr), sort_keys=True)


def test_disabled_registry_records_nothing():
    r = tobs.Registry()
    c = r.counter("pd_test_c", "c")
    r.disable()
    c.inc(5)
    r.enable()
    c.inc(1)
    assert "pd_test_c 1" in tobs.to_prometheus_text(r)


@pytest.mark.parametrize("capacity,n", [(8, 5), (16, 100), (4096, 3000)])
def test_quantile_digest_matches(capacity, n):
    rng = np.random.default_rng(capacity + n)
    vals = rng.lognormal(-4, 1.5, size=n)
    jd, td = jobs.QuantileDigest(capacity), tobs.QuantileDigest(capacity)
    for v in vals:
        jd.observe(v)
        td.observe(v)
    qs = [0.0, 0.5, 0.9, 0.99, 1.0]
    assert td.quantiles(qs) == jd.quantiles(qs)
    assert [td.quantile(q) for q in qs] == [jd.quantile(q) for q in qs]
    assert td.values() == jd.values()
    # within the window the digest is numpy's linear percentile
    window = vals[-capacity:]
    np.testing.assert_allclose(td.quantile(0.9),
                               np.percentile(window, 90), rtol=1e-12)


def test_slo_digest_matches():
    rng = np.random.default_rng(5)
    jd, td = jobs.SLODigest(capacity=64), tobs.SLODigest(capacity=64)
    for _ in range(500):
        metric = ["ttft", "itl", "queue_wait"][int(rng.integers(0, 3))]
        tenant = ["acme", "bolt"][int(rng.integers(0, 2))]
        prio = int(rng.integers(0, 3))
        v = float(rng.exponential(0.05))
        jd.observe(metric, tenant, prio, v)
        td.observe(metric, tenant, prio, v)
    assert td.keys() == jd.keys()
    assert td.snapshot() == jd.snapshot()
    jr, tr = jobs.Registry(), tobs.Registry()
    jd.publish(jr)
    td.publish(tr)
    assert tobs.to_prometheus_text(tr) == jobs.to_prometheus_text(jr)
    td.disable()
    td.observe("ttft", "acme", 0, 1.0)
    assert td.snapshot() == jd.snapshot()


def _emit(rec):
    for i in range(40):
        rec.emit("request", ["queued", "prefill", "finished"][i % 3],
                 rid=i % 5, ts=100.0 + i, dur=(0.5 if i % 2 else 0.0),
                 tokens=i)
        rec.emit("engine", "mixed_step", ts=100.0 + i + 0.25, dur=0.1,
                 bucket=16)


def test_recorder_ring_and_views():
    jr, tr = jrec.FlightRecorder(capacity=32), trec.FlightRecorder(
        capacity=32)
    _emit(jr)
    _emit(tr)
    assert len(tr) == 32 == tr.capacity
    assert [e.to_dict() for e in tr.snapshot()] == \
        [e.to_dict() for e in jr.snapshot()]
    assert [e.to_dict() for e in tr.snapshot(last=5)] == \
        [e.to_dict() for e in jr.snapshot(last=5)]
    assert [e.to_dict() for e in tr.events_for(3)] == \
        [e.to_dict() for e in jr.events_for(3)]
    assert len(tr.by_category("engine")) == 16
    assert tr.request_ids() == jr.request_ids()
    tr.disable()
    tr.emit("request", "queued", rid=1)
    assert len(tr) == 32
    tr.clear()
    assert len(tr) == 0


def test_chrome_trace_matches():
    jr, tr = jrec.FlightRecorder(capacity=256), trec.FlightRecorder(
        capacity=256)
    _emit(jr)
    _emit(tr)
    assert tct.to_chrome_trace(recorder=tr) == jct.to_chrome_trace(
        recorder=jr)
    extra = tct.host_events_to_events([("span", 100.5, 100.75)])
    assert extra[0].dur == pytest.approx(0.25)


def test_device_trace_merge(tmp_path):
    tr = trec.FlightRecorder(capacity=64)
    _emit(tr)
    host = tct.to_chrome_trace(recorder=tr)
    device = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "ragged_kernel", "pid": 0,
         "tid": 7, "ts": 5000.0, "dur": 12.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
         "tid": 7, "ts": 4990.0, "dur": 3.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
         "tid": 1, "ts": 4000.0, "dur": 50.0}]}
    path = tmp_path / "device.json"
    path.write_text(json.dumps(device))
    merged = tct.merge_device_trace(host, str(path), offset_us=100.0)
    dev = [e for e in merged["traceEvents"]
           if e["pid"] == tct.DEVICE_PID and e["ph"] != "M"]
    assert [e["name"] for e in dev] == ["Memcpy HtoD", "ragged_kernel"]
    assert [e["ts"] for e in dev] == [100.0, 110.0]
    assert len(merged["traceEvents"]) == len(host["traceEvents"]) + 4
    assert tct.merge_device_trace(host, {"traceEvents": []}) == host


def test_span_lands_in_profiler_histogram_and_recorder():
    reg = tobs.Registry()
    rec = trec.FlightRecorder(capacity=16)
    prev = tobs.set_default_recorder(rec)
    from torch.profiler import profile, ProfilerActivity
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tobs.span("pd_test_span", registry=reg):
                torch.ones(4).sum()
    finally:
        tobs.set_default_recorder(prev)
    assert any(e.key == "pd_test_span" for e in prof.key_averages())
    assert [e.name for e in rec.by_category("host")] == ["pd_test_span"]
    fam = tobs.to_json(reg)["pd_host_span_seconds"]
    assert fam["series"][0]["labels"] == {"span": "pd_test_span"}
    assert fam["series"][0]["count"] == 1


def test_instrument_jit_counts_fresh_signatures():
    reg = tobs.Registry()
    calls = []

    def step(x, n, levels):
        calls.append(n)
        return x * n

    f = tobs.instrument_jit(step, "g", registry=reg)
    a, b = torch.zeros(4), torch.zeros(8)
    for x, n in ((a, 1), (a, 1), (b, 1), (a, 2), (a, 1)):
        f(x, n, (a, [b]))
    assert len(f.signatures_seen) == 3 and len(calls) == 5
    text = tobs.to_prometheus_text(reg)
    assert 'pd_xla_compiles_total{graph="g"} 3' in text
    assert 'pd_jit_call_seconds_count{graph="g"} 5' in text
    assert tobs.jit_signature((a,), {}) != tobs.jit_signature((b,), {})
    g = tobs.instrument_jit(step, "h", registry=reg, count_compiles=False)
    g(a, 1, (a, [b]))
    g(b, 2, (a, [b]))
    text = tobs.to_prometheus_text(reg)
    assert 'pd_xla_compiles_total{graph="h"}' not in text
    assert 'pd_jit_call_seconds_count{graph="h"} 2' in text


def test_metrics_server_on_localhost():
    reg = _drive_registry(tobs, 0)
    with tobs.start_metrics_server(port=0, registry=reg) as srv:
        text = urllib.request.urlopen(srv.url, timeout=10).read().decode()
        js = json.loads(urllib.request.urlopen(srv.url + ".json",
                                               timeout=10).read())
    assert text == tobs.to_prometheus_text(reg)
    assert js == json.loads(json.dumps(tobs.to_json(reg)))


def test_watchdog_dumps_one_stall(tmp_path):
    reg, rec = tobs.Registry(), trec.FlightRecorder(capacity=16)
    rec.emit("engine", "step")
    wd = tobs.Watchdog(deadline_s=1.0, dump_path=str(tmp_path),
                       registry=reg, recorder=rec, start=False)
    progress = [0]
    wd.watch("engine", lambda: progress[0], busy_fn=lambda: True,
             describe_fn=lambda: {"7": {"state": "running"}})
    assert not wd.check(now=10.0)        # first look: records progress
    assert not wd.check(now=10.5)
    assert wd.check(now=11.5)            # stalled past the deadline
    assert not wd.check(now=20.0)        # one dump per stall
    dump = json.loads(open(wd.last_dump_path).read())
    assert dump["source"] == "engine" and dump["requests"]["7"]
    assert dump["events"][0]["name"] == "step"
    progress[0] += 1
    assert not wd.check(now=21.0)        # progress re-arms it
    assert wd.status()["stalls_total"] == 1
    wd.stop()


def _families(fams):
    return {f.name: type(f).__name__ for f in fams.values()}


def test_metric_catalog_is_the_jax_one():
    treg, jreg = tobs.Registry(), jobs.Registry()
    tfam = _families(tobs.serving_metrics(treg))
    jfam = _families(jobs.serving_metrics(jreg))
    port_only = {"pd_device_fault_retries_total"}
    for name, kind in tfam.items():
        if name not in port_only:
            assert jfam[name] == kind, name
    assert _families(tobs.ledger_metrics(treg)) == \
        _families(jobs.ledger_metrics(jreg))
    assert tobs.PHASES == jobs.PHASES


def test_enable_disable_switch_the_defaults():
    try:
        tobs.disable()
        assert not tobs.default_registry().enabled
        assert not tobs.default_recorder().enabled
        assert not tobs.default_slo_digest().enabled
    finally:
        tobs.enable()
    assert tobs.default_registry().enabled
    assert tobs.default_slo_digest().enabled

"""The port's ``profiler``, ``cost_model`` and
``observability.training_metrics`` against the JAX package's, on the
CPU.

- ``make_scheduler``: the state of each of 20 steps equals the JAX
  package's, for several (closed, ready, record, repeat, skip_first);
- a ``Profiler`` over that schedule records the same steps: the same
  ``RecordEvent`` names and counts in ``events()`` and the same rows of
  ``summary()`` (timings aside), events outside a recording window are
  not collected, a second session starts clean, and the scheduled
  captures call ``on_trace_ready`` as often as the JAX package's;
- ``export_chrome_tracing`` writes the host events (parseable JSON
  naming each ``RecordEvent``) and torch.profiler's trace beside them;
  ``export_protobuf`` / ``load_profiler_result`` round-trip the events;
  a READY step prepares torch.profiler, whose trace then holds the
  recorded steps' ops alone;
- ``benchmark()`` counts steps and samples as the JAX package's and
  publishes the four ``pd_training_*`` families with the JAX names and
  help strings;
- ``CostModel.profile_measure`` on the same small static program: one
  time per record under ``"{op_name}#{i}"``, every time non-negative, a
  whole-program time, and the ``"time"``-only refusal.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.observability as jobs  # noqa: E402
import paddle_tpu.profiler as jprof  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.observability as tobs  # noqa: E402
import paddle_tpu_torch.profiler as tprof  # noqa: E402
from paddle_tpu.cost_model import CostModel as JCostModel  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.cost_model import CostModel as TCostModel  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


SCHEDULES = [dict(closed=1, ready=1, record=2, repeat=1),
             dict(closed=2, ready=0, record=3, repeat=0),
             dict(closed=0, ready=2, record=1, repeat=3, skip_first=2),
             dict(closed=3, ready=1, record=4, repeat=2, skip_first=1)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=str)
def test_scheduler_states_match(kw):
    js, ts = jprof.make_scheduler(**kw), tprof.make_scheduler(**kw)
    assert [ts(i).name for i in range(20)] == [js(i).name for i in range(20)]


def _session(prof_mod, pkg, schedule, steps=8, handler=None):
    calls = []
    on_ready = handler or (lambda prof: calls.append(prof._step))
    prof = prof_mod.Profiler(scheduler=prof_mod.make_scheduler(**schedule),
                             on_trace_ready=on_ready,
                             timer_only=handler is None)
    prof_mod.Profiler.clear_events()
    prof.start()
    for _ in range(steps):
        with prof_mod.RecordEvent("forward"):
            pkg.ones([8, 8]) @ pkg.ones([8, 8])
        with prof_mod.RecordEvent("backward"):
            pass
        prof.step(num_samples=8)
    prof.stop()
    return prof, calls


def _rows(summary):
    """(name, calls) of each summary row."""
    rows = []
    for line in summary.splitlines()[2:]:
        parts = line.split()
        if len(parts) == 6 and parts[1].isdigit():
            rows.append((parts[0], int(parts[1])))
    return sorted(rows)


@pytest.mark.parametrize("kw", SCHEDULES[:2], ids=str)
def test_profiler_records_the_same_steps(kw):
    got = {}
    for mod, pkg in ((jprof, jp), (tprof, tp)):
        prof, _ = _session(mod, pkg, kw)
        events = mod.Profiler.events()
        got[mod] = (sorted(e[0] for e in events), _rows(prof.summary()))
        n = len(events)
        with mod.RecordEvent("outside"):
            pass
        assert len(mod.Profiler.events()) == n
    assert got[tprof] == got[jprof]
    assert got[tprof][0]


def test_second_session_starts_clean():
    p1 = tprof.Profiler(timer_only=True)
    p1.start()
    with tprof.RecordEvent("old"):
        pass
    p1.stop()
    p2 = tprof.Profiler(timer_only=True)
    p2.start()
    p2.stop()
    assert not any(e[0] == "old" for e in tprof.Profiler.events())


def test_trace_handlers(tmp_path):
    d = str(tmp_path / "trace")
    handler = tprof.export_chrome_tracing(d, worker_name="w")
    prof, _ = _session(tprof, tp, SCHEDULES[0], handler=handler)
    assert handler._count == 1
    host = json.load(open(handler.last_path))
    names = {e.get("name") for e in host["traceEvents"]}
    assert {"forward", "backward"} <= names
    dev = json.load(open(handler.last_device_path))
    assert any(e.get("name") == "forward" for e in dev["traceEvents"])
    assert sorted(os.listdir(d)) == ["w.1.pd_trace.json", "w.1.pt.trace.json"]
    pb = tprof.export_protobuf(str(tmp_path / "pb"), "r")(prof)
    assert tprof.load_profiler_result(pb) == tprof.Profiler.events()
    # a device target without a card raises rather than falling back
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tprof.Profiler(targets=[tprof.ProfilerTarget.GPU])


def test_ready_warms_the_trace_and_records_only_recorded_steps(tmp_path):
    """A READY step prepares torch.profiler (its warm-up); the trace
    holds the ops of the RECORD steps alone, and a session that stops in
    READY ends its warm-up without a capture."""
    handler = tprof.export_chrome_tracing(str(tmp_path), worker_name="w")
    x = torch.ones(8, 8)
    prepared = []
    with tprof.Profiler(scheduler=tprof.make_scheduler(
            closed=1, ready=1, record=2, repeat=1),
            on_trace_ready=handler) as prof:
        for i in range(6):
            for _ in range(i + 1):
                torch.mm(x, x)
            prof.step()
            prepared.append(prof._prepared)
    assert prepared == [True, True, True, False, False, False]
    events = json.load(open(handler.last_device_path))["traceEvents"]
    assert sum(e.get("name") == "aten::mm" for e in events) == 3 + 4
    with tprof.Profiler(scheduler=tprof.make_scheduler(
            closed=0, ready=5, record=1, repeat=1),
            on_trace_ready=handler) as prof:
        prof.step()
        assert prof._prepared
    assert not prof._prepared and handler._count == 1


def test_benchmark_and_training_metrics():
    reports = {}
    for mod, obs in ((jprof, jobs), (tprof, tobs)):
        reg = obs.Registry()
        saved = obs.default_registry()
        obs.set_default_registry(reg)
        try:
            b = mod.benchmark()
            b.reset()
            b.begin()
            for _ in range(5):
                b.step(num_samples=4)
            rep = b.report()
            fams = obs.training_metrics(reg)
            reports[mod] = (rep["steps"], rep["ips"] > 0,
                            fams["steps"].value, fams["samples"].value,
                            sorted((k, f.name, f.help)
                                   for k, f in fams.items()))
        finally:
            obs.set_default_registry(saved)
    assert reports[tprof] == reports[jprof]
    assert reports[tprof][:4] == (5, True, 5, 20)


def _program(p):
    p.enable_static()
    try:
        main, startup = p.static.Program(), p.static.Program()
        with p.static.program_guard(main, startup):
            x = p.static.data("x", [4, 8], "float32")
            h = p.static.nn.fc(x, 16, activation="relu")
            p.static.nn.fc(h, 2)
    finally:
        p.disable_static()
    return main, startup


def test_profile_measure():
    feed = {"x": np.random.default_rng(0).standard_normal(
        (4, 8)).astype("float32")}
    got = {}
    for p, cm_cls in ((jp, JCostModel), (tp, TCostModel)):
        main, startup = _program(p)
        cm = cm_cls()
        res = cm.profile_measure(main, startup, feed=feed, repeat=2)
        keys = list(res["op_time_ms"])
        assert keys == [f"{r.op_name}#{i}" for i, r in enumerate(main.ops)]
        assert all(v >= 0 for v in res["op_time_ms"].values())
        assert res["program_time_ms"] is not None
        assert sum(cm.static_cost_data().values()) > 0
        name = keys[0].split("#")[0]
        assert cm.get_op_cost(name) > 0 and cm.get_op_cost("nothing") == 0.0
        got[p] = len(keys)
        with pytest.raises(ValueError):
            cm.profile_measure(main, fetch_cost_list=("time", "memory"))
    assert got[tp] >= 1 and got[jp] >= 1

"""The port's fault injection (``inference/llm/faults.py``) and its
device-fault boundary against the JAX package's, on the CPU.

- ``FaultInjector``: the same config and seed give the same draws, in
  any interleaving of the consults, as the JAX injector; one card is no
  mesh (``dead_device`` None).
- NaN rows (``nan_rate``) at async depths 0, 1 and 2: the same requests
  end ``device_fault`` in both engines, every other request's tokens
  are equal, the injector's counts are equal, the pool ends exactly
  restored; at depth > 0 the port retries once per injected row.
- Dispatch faults (``dispatch_rate``): the same, at depths 0 and 1.
- A targeted poisoning of one request: the survivors are bit-exact
  across depths 0, 1 and 2 and equal to the clean run.
- Real faults: no step is ever served from another route. A row whose
  logits read non-finite once on the engine's route survives the depth-0
  retry, which runs the step again on that same route, with the clean
  run's tokens; at depth > 0 it is quarantined with no re-run, and a row
  non-finite on every run is quarantined at depths 0, 1 and 2; a
  dispatch that raises propagates, as a sticky CUDA error does.
- ``run_chaos``: the same report (reasons, injections, terminal states,
  pool checks) as the JAX harness on the JAX engine, deadlines off.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.inference.llm import CacheConfig as JaxCacheConfig  # noqa: E402
from paddle_tpu.inference.llm import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu.inference.llm import JaxLM  # noqa: E402
from paddle_tpu.inference.llm import (  # noqa: E402
    SchedulerConfig as JaxSchedulerConfig)
from paddle_tpu.inference.llm import faults as jf  # noqa: E402
from paddle_tpu_torch.inference.llm import (  # noqa: E402
    CacheConfig, GenerationEngine, SchedulerConfig, TorchLM)
from paddle_tpu_torch.inference.llm import faults as tf  # noqa: E402
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


def _geom():
    return dict(num_layers=2, num_heads=2, head_dim=16, max_slots=3,
                num_pages=64, max_seq_len=128)


def _sched(depth, **kw):
    cfg = dict(max_slots=3, max_seq_len=128, chunk_tokens=8,
               async_depth=depth)
    cfg.update(kw)
    return cfg


def _engine(side, models, depth, injector, **kw):
    mod = jf if side == "jax" else tf
    prev = mod.set_default_injector(injector)
    try:
        if side == "jax":
            eng = JaxEngine(models[0], cache_config=JaxCacheConfig(**_geom()),
                            scheduler_config=JaxSchedulerConfig(
                                **_sched(depth, **kw)))
            eng.stepprof.disable()
            return eng
        return GenerationEngine(models[1], cache_config=CacheConfig(**_geom()),
                                scheduler_config=SchedulerConfig(
                                    **_sched(depth, **kw)), device="cpu")
    finally:
        mod.set_default_injector(prev)


def _prompts(n=8, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=int(rng.integers(4, 30))).tolist()
            for _ in range(n)]


def _serve(eng, prompts, mnt=10):
    rids = [eng.submit(p, mnt) for p in prompts]
    eng.run()
    reqs = [eng.scheduler.requests[r] for r in rids]
    return [r.finish_reason for r in reqs], [list(r.output) for r in reqs]


def test_injector_draws_match_jax():
    kw = dict(alloc_fail_rate=0.3, delay_rate=0.2, delay_ms=1.0,
              cancel_rate=0.25, malformed_rate=0.1, seed=77, kill_step=5,
              nan_rate=0.15, dispatch_rate=0.1, collective_rate=0.2)
    ji, ti = jf.FaultInjector(jf.FaultConfig(**kw)), tf.FaultInjector(
        tf.FaultConfig(**kw))
    rng = np.random.default_rng(0)
    for _ in range(400):
        op = int(rng.integers(0, 8))
        if op == 0:
            got = (ti.alloc_fail(), ji.alloc_fail())
        elif op == 1:
            got = (ti.step_delay_s(), ji.step_delay_s())
        elif op == 2:
            got = (ti.should_kill(), ji.should_kill())
        elif op == 3:
            got = (ti.nan_row(3), ji.nan_row(3))
        elif op == 4:
            got = (ti.dispatch_fault(), ji.dispatch_fault())
        elif op == 5:
            got = (ti.should_cancel(), ji.should_cancel())
        elif op == 6:
            got = (ti.should_malform(), ji.should_malform())
        else:
            got = (ti.choice([1, 2, 3, 4]), ji.choice([1, 2, 3, 4]))
        assert got[0] == got[1]
    assert ti.counts == ji.counts and ti.active
    ti.reset()
    ji.reset()
    assert [ti.nan_row() for _ in range(20)] == \
        [ji.nan_row() for _ in range(20)]


def test_config_from_env_and_one_card(monkeypatch):
    monkeypatch.setenv("PD_FAULT_NAN_RATE", "0.25")
    monkeypatch.setenv("PD_FAULT_KILL_STEP", "7")
    monkeypatch.setenv("PD_FAULT_DEVICE_DEAD", "1")
    assert tf.FaultConfig.from_env() == tf.FaultConfig(
        **vars(jf.FaultConfig.from_env()))
    inj = tf.FaultInjector(tf.FaultConfig(device_dead=0, device_dead_step=1))
    assert inj.dead_device([0]) is None          # one card: no mesh
    ji = jf.FaultInjector(jf.FaultConfig(device_dead=1, device_dead_step=2))
    ti = tf.FaultInjector(tf.FaultConfig(device_dead=1, device_dead_step=2))
    assert [ti.dead_device([0, 1, 2, 3]) for _ in range(3)] == \
        [ji.dead_device([0, 1, 2, 3]) for _ in range(3)] == [None, 1, 1]


def _parity(models, depth, cfg):
    out = {}
    for side, mod in (("jax", jf), ("torch", tf)):
        eng = _engine(side, models, depth,
                      mod.FaultInjector(mod.FaultConfig(**cfg)))
        reasons, outputs = _serve(eng, _prompts())
        eng.cache.check_invariants()
        out[side] = (reasons, outputs, dict(eng._faults.counts),
                     eng.cache.num_free_pages, eng)
    return out


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_nan_rows_end_the_same_requests(models, depth):
    out = _parity(models, depth, dict(nan_rate=0.05, seed=11))
    (jr, jo, jc, jfree, _), (tr, to, tc, tfree, eng) = (out["jax"],
                                                        out["torch"])
    assert tr == jr and to == jo and tc == jc
    assert "device_fault" in tr and tr.count("device_fault") < len(tr)
    assert tfree == jfree == eng.cache.config.num_pages - 1
    assert eng.scheduler.stats["n_device_faults"] == tr.count("device_fault")
    if depth:
        assert eng.fault_retries["nan"] == tc["nan"]
    else:
        assert 0 < eng.fault_retries["nan"] <= tc["nan"]


@pytest.mark.parametrize("depth", [0, 1])
def test_dispatch_faults_end_the_same_requests(models, depth):
    out = _parity(models, depth, dict(dispatch_rate=0.3, seed=8))
    (jr, jo, jc, jfree, _), (tr, to, tc, tfree, eng) = (out["jax"],
                                                        out["torch"])
    assert tr == jr and to == jo and tc == jc
    assert "device_fault" in tr
    assert tfree == jfree == eng.cache.config.num_pages - 1
    if depth:
        assert eng.fault_retries["dispatch"] == tc["dispatch"]
    else:
        assert 0 < eng.fault_retries["dispatch"] <= tc["dispatch"]


class _Victim(tf.FaultInjector):
    """Poisons the rows of one request (by rid) from its ``at``-th scan
    on, twice: the depth-0 retry scans again (as the JAX engine's does)
    and must see the poison persist."""

    def __init__(self, rid, at):
        super().__init__(tf.FaultConfig(nan_rate=1e-9))
        self.rid, self.at, self.seen = rid, at, 0

    def nan_row(self, rid=None):
        if rid != self.rid:
            return False
        self.seen += 1
        hit = self.seen in (self.at, self.at + 1)
        if hit:
            self.counts["nan"] = self.counts.get("nan", 0) + 1
        return hit


def test_survivors_are_bit_exact_across_depths(models):
    prompts = _prompts(7, seed=19)
    clean = _serve(_engine("torch", models, 0, tf.FaultInjector(
        tf.FaultConfig())), prompts)
    runs = {}
    for depth in (0, 1, 2):
        eng = _engine("torch", models, depth, _Victim(None, 3))
        eng._faults.rid = eng.scheduler._next_rid + 2     # the third request
        reasons, outputs = _serve(eng, prompts)
        assert reasons[2] == "device_fault"
        assert reasons.count("device_fault") == 1
        assert eng.fault_retries["nan"] == 1
        eng.cache.check_invariants()
        assert eng.cache.pages_in_use == 0
        runs[depth] = [o for i, o in enumerate(outputs) if i != 2]
    want = [o for i, o in enumerate(clean[1]) if i != 2]
    assert runs[0] == runs[1] == runs[2] == want


def _poison_once(eng, slot_of_rid, steps_to_skip=3, once=True):
    """The engine's route reports one row's logits non-finite once (the
    retry, on the same route, computes them afresh), or on every run
    from then on (``once=False``)."""
    inner = eng._run_step
    state = {"n": 0, "done": False}

    def run(bucket, ints, floats, max_q, levels):
        toks, ok = inner(bucket, ints, floats, max_q, levels)
        state["n"] += 1
        slot = slot_of_rid()
        if (not (once and state["done"]) and state["n"] > steps_to_skip
                and slot is not None):
            ms = eng.scheduler.config.max_slots
            qs = int(ints[slot])
            ql = int(ints[ms + slot])
            if ql:
                ok = ok.clone()
                ok[qs:qs + ql] = False
                state["done"] = True
        return toks, ok
    eng._run_step = run
    eng._eager_fn = run
    return state


def _poisoned_run(models, depth, prompts, once):
    """Serve ``prompts`` with the first request's row reported
    non-finite by the engine's route (once, or on every run); returns
    (engine, reasons, outputs, poisoning state)."""
    eng = _engine("torch", models, depth, tf.FaultInjector(tf.FaultConfig()))
    first = eng.scheduler._next_rid

    def slot_of_first():
        req = eng.scheduler.requests.get(first)
        return req.slot if req is not None and req.slot >= 0 else None
    state = _poison_once(eng, slot_of_first, once=once)
    reasons, outputs = _serve(eng, prompts)
    return eng, reasons, outputs, state


@pytest.mark.parametrize("depth", [0, 1])
def test_real_nan_recovered_by_the_retry(models, depth):
    """A row non-finite once on the engine's route: at depth 0 the retry
    runs the whole step again on that same route (never another one)
    and the row survives with the clean run's tokens; at depth > 0, as
    in the JAX engine, the retry is recorded, not run, and the row's
    request ends ``device_fault`` while the others equal the clean
    run."""
    prompts = _prompts(5, seed=23)
    clean = _serve(_engine("torch", models, depth, tf.FaultInjector(
        tf.FaultConfig())), prompts)
    eng, reasons, outputs, state = _poisoned_run(models, depth, prompts,
                                                 once=True)
    assert state["done"]
    assert eng.fault_retries == {"nan": 1, "dispatch": 0}
    if depth == 0:
        assert (reasons, outputs) == clean
        assert eng.scheduler.stats["n_device_faults"] == 0
    else:
        assert reasons[0] == "device_fault"
        assert reasons[1:] == clean[0][1:] and outputs[1:] == clean[1][1:]
        assert eng.scheduler.stats["n_device_faults"] == 1
    eng.cache.check_invariants()
    assert eng.cache.pages_in_use == 0


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_persistent_real_nan_is_quarantined(models, depth):
    """A row non-finite on every run of the engine's route is retried
    once (depth 0: the step runs again on the same route) and then its
    request alone ends ``device_fault``; no other route serves it."""
    prompts = _prompts(5, seed=23)
    clean = _serve(_engine("torch", models, depth, tf.FaultInjector(
        tf.FaultConfig())), prompts)
    eng, reasons, outputs, state = _poisoned_run(models, depth, prompts,
                                                 once=False)
    assert reasons[0] == "device_fault"
    assert reasons[1:] == clean[0][1:] and outputs[1:] == clean[1][1:]
    assert eng.fault_retries == {"nan": 1, "dispatch": 0}
    assert eng.scheduler.stats["n_device_faults"] == 1
    eng.cache.check_invariants()
    assert eng.cache.pages_in_use == 0


@pytest.mark.parametrize("depth", [0, 1])
def test_raising_dispatch_is_retried_on_the_plain_route(models, depth):
    """A real exception from the engine's route is not retried on the
    plain route (nor on any other): it propagates out of ``step`` with
    no retry and no ``device_fault`` recorded."""
    prompts = _prompts(5, seed=29)
    eng = _engine("torch", models, depth, tf.FaultInjector(tf.FaultConfig()))
    inner = eng._run_step
    calls = []

    def run(bucket, ints, floats, max_q, levels):
        calls.append(bucket)
        if len(calls) == 4:
            raise RuntimeError("kernel launch refused: invalid argument")
        return inner(bucket, ints, floats, max_q, levels)
    eng._run_step = run
    eng._eager_fn = run
    with pytest.raises(RuntimeError, match="invalid argument"):
        _serve(eng, prompts)
    assert len(calls) == 4
    assert eng.fault_retries == {"nan": 0, "dispatch": 0}
    assert eng.scheduler.stats["n_device_faults"] == 0


def test_sticky_cuda_error_propagates(models):
    eng = _engine("torch", models, 0, tf.FaultInjector(tf.FaultConfig()))

    def run(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    eng._run_step = run
    eng._eager_fn = run
    eng.submit([1, 2, 3], 4)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.step()
    assert eng.fault_retries["dispatch"] == 0


def test_run_chaos_report_matches_jax(models):
    cfg = dict(alloc_fail_rate=0.2, cancel_rate=0.1, malformed_rate=0.2,
               nan_rate=0.02, dispatch_rate=0.02, seed=5)
    reps = {}
    for side, mod in (("jax", jf), ("torch", tf)):
        inj = mod.FaultInjector(mod.FaultConfig(**cfg))
        eng = _engine(side, models, 0, inj, priority_classes=3,
                      tenant_max_slots=2)
        rep = mod.run_chaos(eng, n_requests=30, vocab=VOCAB, seed=3,
                            injector=inj, deadline_fraction=0.0)
        reps[side] = rep
    t, j = reps["torch"], reps["jax"]
    for key in ("steps", "submitted", "rejected_queue_full",
                "malformed_attempts", "malformed_leaks", "injected",
                "drained", "all_terminal", "truthful_reasons", "reasons",
                "cancelled", "preemptions", "device_faults",
                "free_pages_restored", "invariants_ok"):
        assert t[key] == j[key], key
    assert t["drained"] and t["all_terminal"] and t["truthful_reasons"]
    assert t["free_pages_restored"] and t["invariants_ok"]
    assert t["malformed_attempts"] > 0 and t["malformed_leaks"] == 0
    assert t["device_faults"] > 0

"""The port's cost ledger (``observability/ledger.py``) and
``quant.modeled_weight_bytes`` against the JAX package's, on the CPU.

- Per step, integer-equal: the same request set through the JAX engine
  (its step profiler off) and the port, float32, int8 and fp8 pages,
  int8 weights, the KV split on and off: every landed step's modelled
  HBM bytes and FLOPs, the component totals, the per-tenant and
  per-request attribution and the split-row histogram are equal integers.
- ``modeled_weight_bytes`` equal for float and int8 weights.
- Per-tenant sums (and per-request sums) equal the engine totals
  exactly; the int8-vs-off byte ratio is the JAX ledger's.
- Compile observatory: the misses of each package's ledger equal that
  package's ``xla_compiles``; a miss past the port's ``graph_bound``
  raises the storm counter; a capture's time and memory land in
  ``captures``; the ledger off (``PD_COST_LEDGER=0``) leaves tokens
  unchanged.
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
from paddle_tpu.inference.llm import quant as jquant  # noqa: E402
from paddle_tpu_torch import observability as tobs  # noqa: E402
from paddle_tpu_torch.inference.llm import (  # noqa: E402
    CacheConfig, GenerationEngine, ModelSpec, SchedulerConfig, TorchLM)
from paddle_tpu_torch.inference.llm import quant as tquant  # noqa: E402
from paddle_tpu_torch.inference.llm.model import params_from_jax  # noqa: E402
from paddle_tpu_torch.observability.ledger import (  # noqa: E402
    StepLedger, integer_split)
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
                num_pages=64, page_size=8, max_seq_len=128)


def _sched(kv, split):
    return dict(max_slots=3, max_seq_len=128, chunk_tokens=8,
                kv_quant=kv, weight_quant="int8" if kv != "off" else "off",
                kv_split_pages=split)


def _record(ledger):
    steps = []
    inner = ledger.account_step

    def account(rows):
        out = inner(rows)
        steps.append(out)
        return out
    ledger.account_step = account
    return steps


def _workload(seed=4, n=7):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, VOCAB, size=16).tolist()
    prompts = [(shared if i % 3 == 0 else [])
               + rng.integers(0, VOCAB, size=int(rng.integers(3, 40))).tolist()
               for i in range(n)]
    return prompts, [int(rng.integers(2, 12)) for _ in range(n)]


def _run(eng, prompts, mnts):
    rids = [eng.submit(p, m, tenant=("acme", "bolt", "corp")[i % 3])
            for i, (p, m) in enumerate(zip(prompts, mnts))]
    eng.run()
    return rids


def _both(models, kv, split):
    jeng = JaxEngine(models[0], cache_config=JaxCacheConfig(**_geom()),
                     scheduler_config=JaxSchedulerConfig(**_sched(kv, split)))
    jeng.stepprof.disable()
    teng = GenerationEngine(models[1], cache_config=CacheConfig(**_geom()),
                            scheduler_config=SchedulerConfig(
                                **_sched(kv, split)), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("split", [0, 2])
@pytest.mark.parametrize("kv", ["off", "int8", "fp8"])
def test_per_step_bytes_and_flops_equal_jax(models, kv, split):
    jeng, teng = _both(models, kv, split)
    jsteps, tsteps = _record(jeng.ledger), _record(teng.ledger)
    prompts, mnts = _workload()
    jr, tr = _run(jeng, prompts, mnts), _run(teng, prompts, mnts)
    assert tsteps == jsteps and len(tsteps) > 5
    assert all(isinstance(b, int) and isinstance(f, int) for b, f in tsteps)
    js, ts = jeng.ledger.summary(), teng.ledger.summary()
    for key in ("total_hbm_bytes", "total_flops", "steps_accounted",
                "weight_bytes_per_step", "page_bytes", "tenant_hbm_bytes",
                "tenant_flops", "component_bytes", "kv_split_rows"):
        assert ts[key] == js[key], key
    for a, b in zip(tr, jr):
        ta, ja = teng.scheduler.requests[a], jeng.scheduler.requests[b]
        assert (ta.cost_hbm_bytes, ta.cost_flops) == \
            (ja.cost_hbm_bytes, ja.cost_flops)
        assert ta.output == ja.output
    if split:
        assert len(ts["kv_split_rows"]) > 1     # some rows split


@pytest.mark.parametrize("weights", ["off", "int8"])
@pytest.mark.parametrize("spec", [
    dict(vocab=64, d_model=32, num_layers=2, num_heads=2, head_dim=16,
         max_seq_len=128),
    dict(vocab=50304, d_model=2048, num_layers=24, num_heads=32,
         head_dim=64, max_seq_len=2048)])
def test_modeled_weight_bytes_equal(spec, weights):
    ts = ModelSpec(**spec)
    tq = tquant.QuantConfig(weights=weights)
    jq = jquant.QuantConfig(weights=weights)
    assert tquant.modeled_weight_bytes(ts, tq) == \
        jquant.modeled_weight_bytes(ts, jq)


def test_tenant_and_request_sums_equal_totals(models):
    _, teng = _both(models, "int8", 2)
    prompts, mnts = _workload(seed=9, n=9)
    rids = _run(teng, prompts, mnts)
    led = teng.ledger
    assert sum(led.tenant_hbm_bytes.values()) == led.total_hbm_bytes
    assert sum(led.tenant_flops.values()) == led.total_flops
    assert set(led.tenant_hbm_bytes) == {"acme", "bolt", "corp"}
    reqs = [teng.scheduler.requests[r] for r in rids]
    assert sum(r.cost_hbm_bytes for r in reqs) == led.total_hbm_bytes
    assert sum(r.cost_flops for r in reqs) == led.total_flops
    summ = teng.request_summary(rids[0])
    assert summ["cost_hbm_bytes_per_token"] == \
        reqs[0].cost_hbm_bytes / len(reqs[0].output)
    text = tobs.to_prometheus_text()
    assert 'pd_cost_hbm_bytes_total{tenant="acme"}' in text


def test_int8_byte_ratio_equals_jax(models):
    prompts, mnts = _workload(seed=2)
    totals = {}
    for kv in ("off", "int8"):
        jeng, teng = _both(models, kv, 0)
        _run(jeng, prompts, mnts)
        _run(teng, prompts, mnts)
        totals[kv] = (jeng.ledger.total_hbm_bytes,
                      teng.ledger.total_hbm_bytes)
    j_ratio = totals["int8"][0] / totals["off"][0]
    t_ratio = totals["int8"][1] / totals["off"][1]
    assert t_ratio == j_ratio and t_ratio < 0.5


def _compiles_by_graph(reg):
    fam = tobs.to_json(reg).get("pd_xla_compiles_total", {"series": []})
    return {s["labels"]["graph"]: s["value"] for s in fam["series"]}


def test_compile_misses_equal_xla_compiles(models):
    jeng, teng = _both(models, "off", 0)
    prompts, mnts = _workload()
    _run(jeng, prompts, mnts)
    before = _compiles_by_graph(teng.obs_registry)
    _run(teng, prompts, mnts)
    after = _compiles_by_graph(teng.obs_registry)
    # the compile family has one source, the step signatures: the
    # observed eager step and graph replays time calls and count none
    grown = {g: v - before.get(g, 0.0) for g, v in after.items()}
    assert {g: v for g, v in grown.items() if v} == \
        {"step": teng.xla_compiles}
    assert sum(teng.ledger.cache_misses.values()) == teng.xla_compiles
    assert sum(jeng.ledger.cache_misses.values()) == jeng.xla_compiles
    assert teng.xla_compiles <= teng.graph_bound
    assert teng.ledger.bucket_bound == teng.graph_bound
    assert teng.ledger.storms == 0
    assert sum(teng.ledger.cache_hits.values()) + teng.xla_compiles == \
        teng.steps_dispatched


def test_storm_and_capture_observatory():
    spec = ModelSpec(vocab=64, d_model=32, num_layers=2, num_heads=2,
                     head_dim=16, max_seq_len=128)
    reg = tobs.Registry()
    led = StepLedger(spec, CacheConfig(**_geom()), bucket_bound=2,
                     registry=reg)
    for bucket, miss in ((16, True), (32, True), (32, False), (64, True)):
        led.note_dispatch("step", miss, bucket)
    assert led.storms == 1 and led.cache_misses == {"step": 3}
    info = led.observe_capture("step", 64, 0.25, 1 << 20, 4096, tiles=True)
    assert led.summary()["captures"] == {"step:64:tiles": info}
    text = tobs.to_prometheus_text(reg)
    assert "pd_compile_storms_total 1" in text
    assert 'pd_compile_seconds_count{graph="step"} 1' in text
    assert integer_split(10, [1, 1, 1]) == [4, 3, 3]
    assert sum(integer_split(10**12 + 7, [3, 5, 11, 0])) == 10**12 + 7


def test_ledger_off_leaves_tokens_unchanged(models, monkeypatch):
    prompts, mnts = _workload()
    _, on = _both(models, "int8", 2)
    monkeypatch.setenv("PD_COST_LEDGER", "0")
    _, off = _both(models, "int8", 2)
    assert off.ledger is None
    a, b = _run(on, prompts, mnts), _run(off, prompts, mnts)
    assert [on.output_of(r) for r in a] == [off.output_of(r) for r in b]
    assert all(off.scheduler.requests[r].cost_hbm_bytes == 0 for r in b)
    assert jobs.ledger_metrics is not None

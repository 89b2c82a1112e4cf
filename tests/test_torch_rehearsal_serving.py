"""A CPU rehearsal of ``chip_smoke.py``'s serving phases, with each
kernel wrapper its counting plain version (``tests/_torch_rehearsal.py``):

- the decode and mixed kernel checks at the per-tier shapes (GPT-2-small
  heads);
- the bound arithmetic of the kernels line, and the library yardstick
  (SDPA on K/V gathered dense) computing the plain version's function;
- the ragged times phase and its rows of the kernels line at narrow
  heads (H 2, D 16, the smoke's contexts): both bounds at every shape
  (the tensor-core bound's arithmetic checked by hand on a tiny mix),
  an earlier design's two times when its libraries are given, each
  row's launches by step class and launches x (time - bound); and the
  engine path's count of ragged launches by step class (decode-only
  steps and steps with a chunk or prefix row), which must add up to
  its launches;
- the smoke's build of an earlier ``ragged_attention.cuh`` (the SIMT
  page walk of the parent commit's design as text): each page type's
  library source has the header and its local includes inlined and
  keeps its C entry; and of an earlier decode kernel
  ``paged_attention.cu``: the headers beside it are inlined before the
  port's, and the per-tier times phase (the smoke's shapes, GPT-2-small
  heads) gives its decode row that design's two times;
- the async serving phase (depths 0 and 1 here, the smoke's three
  batches of long-context traffic with prompts cut to a quarter, int8
  KV and weights, the KV split) on a narrow model with GPT-3 XL's
  context (a 1024-token vocabulary): equal tokens across depths and the
  graphs switch (the CPU path runs eagerly either way), launches layers
  x steps in the timed batch, signatures within the bound, one row of
  numbers a run;
- the preemption phase on a narrow model with GPT-2-small's context (a
  1024-token vocabulary), at async depth 1: preemptions, swap-outs and
  swap-ins, quota deferrals and the deadline's timeout all happen, and
  the survivors equal their uncontended runs; the observability and
  the faults-and-journal phases on a narrow model;
- the quantized-serving and fabric phases: the int8 matmul phase at
  narrow shapes (bit-equal codes and products, each shape's numbers,
  and the kernels line's two rows with every key of the contract), the
  narrow-scale ragged kernels and their rows (2-byte scales in the byte
  bound), the weight-matmul phase on a narrow model with GPT-3 XL's
  context (launches four a layer a step, tokens identical across
  engines and chunk budgets, the quality bar), bfloat16 scale pools on
  the main path (partings judged by ``compare_routes``, itself checked
  on made-up logits), and the fabric phase (outputs equal to one
  engine's colocated, killed, disaggregated and with tracing off;
  affinity placement; the alert fires and clears).
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_rehearsal import (  # noqa: E402,F401
    CONTRACT_KEYS, CPU, F, ModelSpec, TorchLM, _Tap, _narrow_model, _narrow_xl,
    _once, cpu_card, cs, i8, init_lm_params, np, pa, plain_kernels)
from _torch_threads import one_thread  # noqa: E402,F401


def test_async_serving_phase(plain_kernels, cpu_card, monkeypatch):
    # GPT-3 XL's context with a 1024-token vocabulary: the plain
    # sampler over 50304 tokens takes most of a step on the CPU
    spec = ModelSpec(vocab=1024, d_model=64, num_layers=2, num_heads=2,
                     head_dim=32, max_seq_len=cs.GPT3_XL.max_seq_len)
    model = TorchLM(spec, init_lm_params(spec, seed=0, device=CPU),
                    device=CPU)
    monkeypatch.setattr(cs, "ASYNC_DEPTHS", (0, 1))
    # the smoke's traffic with each prompt cut to a quarter
    batches = [[(p[:len(p) // 4], sp) for p, sp in cs.requests_long(
        s, spec.vocab)] for s in (11, 13, 17)]
    rows = cs.phase_async_serving(model, batches)
    assert [(r["depth"], r["graphs"]) for r in rows] == [
        (0, False), (0, True), (1, False), (1, True)]
    for r in rows:
        assert r["steps"] > 0 and r["ms_per_step"] > 0
        assert r["signatures"] <= r["graph_bound"]
        assert r["graphs_captured"] == 0          # eager on the CPU
    # depth 1: every mixed step's commit phase left one step in flight
    assert rows[2]["occupancy"][0] == 0 < rows[2]["occupancy"][1]


def test_preempt_swap_phase(plain_kernels, cpu_card):
    spec = ModelSpec(vocab=1024, d_model=64, num_layers=2, num_heads=2,
                     head_dim=32, max_seq_len=cs.GPT2_SMALL.max_seq_len)
    model = TorchLM(spec, init_lm_params(spec, seed=0, device=CPU),
                    device=CPU)
    got = cs.phase_preempt_swap(model)
    assert got["preemptions"] > 0 and got["swapped_in"] > 0
    assert got["ties"] == 0                       # one backend: equal


def test_observability_phase(plain_kernels, cpu_card, monkeypatch):
    """The main path's observability phase at depth 1 (the async phase's
    traffic cut to a quarter): tokens equal on and off, one record per
    committed step, phases summing to each step's wall time, the
    ledger's tenant sums, and the printed numbers present."""
    model = _narrow_model(cs.GPT3_XL.max_seq_len)
    monkeypatch.setattr(cs, "ASYNC_TOKENS", [])
    batches = [[(p[:len(p) // 4], sp) for p, sp in cs.requests_long(
        s, model.spec.vocab)] for s in (11, 13, 17)]
    out = cs.phase_observability(model, batches)
    assert out["steps"] > 0 and out["ms_per_step"] > 0
    assert out["ms_per_step_off"] > 0
    assert set(out["phase_ms"]) >= {"plan", "pack", "dispatch",
                                    "sample_commit"}
    assert out["bytes_per_step"] > 0 and out["flops_per_step"] > 0
    assert out["captures"] == 0                   # eager on the CPU
    assert {"ttft", "itl", "queue_wait"} <= set(out["slo"])
    assert {r["tenant"] for r in out["slo"]["ttft"]} == {"a", "b"}
    from paddle_tpu_torch import observability as obs
    assert obs.default_registry().enabled        # left on


def test_faults_journal_phase(plain_kernels, cpu_card):
    """The journal, fault and brownout phase at GPT-2-small's context on
    a narrow model: the kill lands, the restore equals the clean run,
    seeded NaN rows and dispatch faults are retried once each and end
    only their requests, and the brownout ladder climbs to shedding and
    back to 0."""
    model = _narrow_model(cs.GPT2_SMALL.max_seq_len)
    rep = cs.phase_faults_journal(model)
    assert rep["restore"]["restored"] > 0
    assert rep["restore"]["ties"] == 0            # one backend: equal
    for kind in ("nan", "dispatch"):
        assert rep[kind]["injected"] == rep[kind]["retries"] > 0
        assert rep[kind]["device_faults"] > 0 and rep[kind]["survivors"] > 0
        assert rep[kind]["ties"] == 0
    o = rep["overload"]
    assert o["shed"] + o["overloaded"] > 0 and o["retry_after_s"][0] > 0


def test_per_tier_kernel_phase(plain_kernels):
    errors = cs.phase_per_tier_kernels(CPU)
    assert errors == {pa.PAGED_KERNEL: 0.0, pa.MIXED_KERNEL: 0.0}


def test_bounds_and_library_yardstick():
    decode = cs.per_tier_mix("decode", 40, CPU)
    chunk = cs.per_tier_mix("chunk", 41, CPU)
    H, D = 12, 64
    # decode: every position below each seq_len, K and V, float32
    assert cs.per_tier_work(decode)[0] == (sum(decode["seq_lens"].tolist())
                                           * H * D * 8 + 2 * 9 * H * D * 4)
    # chunk: 512 queries after 512 resident keys, 4 * D per pair and head
    pairs = sum(512 + t + 1 for t in range(512))
    assert cs.per_tier_work(chunk)[1] == pairs * H * 4 * D
    for args in (decode, chunk, cs.per_tier_mix("verify", 42, CPU)):
        qd, k, v, mask = cs.per_tier_sdpa_inputs(args)
        lib = F.scaled_dot_product_attention(qd, k, v, attn_mask=mask)
        ref = cs.per_tier_call(args, "ref")
        ref = ref if ref.dim() == 4 else ref[:, None]
        seen = args["seq_lens"] > 0                # empty slots excluded
        torch.testing.assert_close(lib.transpose(1, 2)[seen], ref[seen],
                                   rtol=2e-5, atol=2e-5)


def test_ragged_times_and_rows(plain_kernels, monkeypatch):
    monkeypatch.setattr(cs, "time_cuda", lambda fn, reps=20, warmup=3:
                        (fn(), 1.0)[1])
    for name, spec in (("GPT3_XL", cs.GPT3_XL), ("GPT2_SMALL",
                                                  cs.GPT2_SMALL)):
        monkeypatch.setattr(cs, name, ModelSpec(
            vocab=64, d_model=32, num_layers=2, num_heads=2, head_dim=16,
            max_seq_len=spec.max_seq_len))
    names = [pa.kernel_name(cs.DTYPES[m], sp) for sp in (False, True)
             for m in cs.MODES]
    int8 = pa.kernel_name(torch.int8, True)
    # the row takes the path its launches come from: the last one whose
    # total matches
    monkeypatch.setattr(cs, "LAUNCHES_BY_STEP", {
        "quantized": {"kernel": int8, "decode": 1200, "mix": 120},
        "other": {"kernel": int8, "decode": 1, "mix": 2}})
    entry = pa._entry
    rows = cs.phase_times(CPU, {n: 1320 if n == int8 else 24 for n in names},
                          {n: 0.0 for n in names}, ("old.cuh", {}))
    assert pa._entry is entry
    assert [r["name"] for r in rows] == names
    root = cs.os.path.dirname(cs.os.path.abspath(cs.__file__))
    for row in rows:
        assert cs.os.path.exists(cs.os.path.join(root, row["source"]))
        assert row["launches"] == (1320 if row["name"] == int8 else 24)
        assert row["ms"] == 1.0
        kinds = {"decode", "mix"} | ({"decode_gpt2_small", "mix_gpt2_small"}
                                     if row["name"] == names[0] else set())
        assert set(row["shapes"]) == kinds
        for t in row["shapes"].values():
            assert t["design_ms"] == [1.0, 1.0]
            assert 0 < t["tc_bound_ms"] <= t["bound_ms"]
            assert {t["bound_by"], t["tc_bound_by"]} <= {"bytes",
                                                         "operations"}
        assert ("launches_by_step" in row) == (row["name"] == int8)
    assert rows[names.index(int8)]["launches_by_step"] == {
        "path": "quantized", "kernel": int8, "decode": 1200, "mix": 120}
    loss = rows[names.index(int8)]["launch_ms_over_bound"]
    shapes = rows[names.index(int8)]["shapes"]
    assert loss == {k: n * (1.0 - shapes[k]["bound_ms"])
                    for k, n in (("decode", 1200), ("mix", 120))}


def test_engine_path_counts_launches_by_step(plain_kernels, monkeypatch):
    spec = ModelSpec(vocab=cs.GPT2_SMALL.vocab, d_model=64, num_layers=2,
                     num_heads=2, head_dim=32,
                     max_seq_len=cs.GPT2_SMALL.max_seq_len)
    model = TorchLM(spec, init_lm_params(spec, seed=0, device=CPU),
                    device=CPU)
    monkeypatch.setattr(cs, "LAUNCHES_BY_STEP", {})
    name = pa.kernel_name(torch.float32, True)
    launches = cs.drive_path("rehearsal", model, cs.requests_gpt2(7), name,
                             split=cs.SPLIT, chunk=cs.CHUNK,
                             min_prefix_pages=256 // cs.PAGE)[0]
    got = cs.LAUNCHES_BY_STEP["rehearsal"]
    assert got["kernel"] == name
    assert got["decode"] > 0 and got["mix"] > 0
    assert got["decode"] + got["mix"] == launches[name]
    assert pa.ragged_attention_cuda.__name__ == "run"     # unwrapped


def test_old_ragged_sources_inline_the_header():
    old = (cs._build.CSRC / "paged_walk.cuh").read_text()
    header = ('#pragma once\n#include "paged_walk.cuh"\n' + old[:0]
              + "#define RAGGED_ATTENTION_ENTRY(NAME, T) int NAME;\n")
    sources = cs.old_ragged_sources(header)
    assert set(sources) == {f"{lib}_old" for lib, _, _ in pa._LIBS.values()}
    for lib, entry, _ in pa._LIBS.values():
        text = sources[f"{lib}_old"]
        assert "#include \"" not in text and "#pragma once" not in text
        assert "namespace paged" in text           # paged_walk.cuh inlined
        assert f"RAGGED_ATTENTION_ENTRY({entry}," in text


def test_old_decode_source_takes_the_headers_beside_it(tmp_path):
    """An earlier ``paged_attention.cu`` with its own ``paged_walk.cuh``
    beside it: that header is inlined, not the port's, and a header not
    beside it comes from ``csrc/``."""
    (tmp_path / "paged_walk.cuh").write_text(
        '#pragma once\n#include "cp_async.cuh"\n// the earlier walk\n')
    text = ('#include "paged_walk.cuh"\n'
            'extern "C" int paged_attention_f32() { return 0; }\n')
    got = cs.inline_includes(text, beside=tmp_path)
    assert "// the earlier walk" in got and "walk_pages" not in got
    assert "namespace cpasync" in got              # from csrc/
    assert '#include "' not in got and "#pragma once" not in got


def test_per_tier_rows_time_an_earlier_decode_kernel(plain_kernels,
                                                     monkeypatch):
    """The per-tier times phase at the smoke's shapes with an earlier
    decode kernel given: the decode row carries that design's two times
    (before and after the kernel's), the mixed row none; ``pa._entry`` is
    the port's own afterwards."""
    monkeypatch.setattr(cs, "time_cuda", lambda fn, reps=20, warmup=3:
                        (fn(), 1.0)[1])
    entry = pa._entry
    names = list(cs.PER_TIER)
    rows = cs.per_tier_rows(CPU, {n: 7 for n in names},
                            {n: 0.0 for n in names}, ("old.cu", None))
    assert pa._entry is entry
    by_name = {r["name"]: r for r in rows}
    decode = by_name[pa.PAGED_KERNEL]["shapes"]["decode"]
    assert decode["design_ms"] == [1.0, 1.0]
    assert 0 < decode["bound_ms"] and decode["bound_by"] == "bytes"
    for kind, t in by_name[pa.MIXED_KERNEL]["shapes"].items():
        assert "design_ms" not in t, kind


def test_int8_matmul_phase_and_rows(plain_kernels, monkeypatch):
    monkeypatch.setattr(cs, "time_cuda", _once)
    monkeypatch.setattr(cs, "INT8_SHAPES", (("wqkv", 32, 96), ("wo", 32, 32),
                                            ("wfc", 32, 128),
                                            ("wproj", 128, 32)))
    monkeypatch.setattr(cs, "INT8_ROWS", (1, 8, 24))
    times = cs.phase_int8_matmul(CPU)
    assert set(times) == {(n, m) for n, _, _ in cs.INT8_SHAPES
                          for m in (1, 8, 24)}
    for (name, m), t in times.items():
        assert (t["int_mm_ms"] is None) == (m <= 16)
        assert t["bound_ms"] > 0 and t["q_bound_ms"] > 0
    rows = cs.int8_rows(times, {i8.INT8_MATMUL_KERNEL: 96,
                                i8.QUANTIZE_ROWS_KERNEL: 96})
    root = cs.os.path.dirname(cs.os.path.abspath(cs.__file__))
    assert [r["name"] for r in rows] == [i8.INT8_MATMUL_KERNEL,
                                         i8.QUANTIZE_ROWS_KERNEL]
    for r in rows:
        assert CONTRACT_KEYS <= set(r)
        assert r["launches"] == 96 and r["max_abs_err"] == 0.0
        assert r["ms"] == 4.0 and r["library_ms"] is None
        assert r["bound_by"] in ("bytes", "operations")
        assert cs.os.path.exists(cs.os.path.join(root, r["source"]))
        assert len(r["shapes"]) == 12
    assert rows[0]["bound_ms"] == sum(
        cs.int8_bounds(8, k, n)["bound_ms"] for _, k, n in cs.INT8_SHAPES)


def test_narrow_kernels_and_rows(plain_kernels, monkeypatch):
    monkeypatch.setattr(cs, "time_cuda", _once)
    _narrow_xl(monkeypatch)
    errors = cs.phase_narrow_kernels(CPU)
    assert set(errors) == set(pa.NARROW_KERNEL_NAMES)
    assert all(e <= cs.ATTN_TOL for e in errors.values())
    rows = cs.narrow_rows(CPU, {n: 7 for n in errors}, errors)
    root = cs.os.path.dirname(cs.os.path.abspath(cs.__file__))
    assert [r["name"] for r in rows] == list(pa.NARROW_KERNEL_NAMES)
    for r in rows:
        assert CONTRACT_KEYS <= set(r) and r["launches"] == 7
        assert cs.os.path.exists(cs.os.path.join(root, r["source"]))
        assert set(r["shapes"]) == {"decode", "mix"}
    # two-byte scales in the byte count
    args, scales, _, _ = cs.narrow_mix("decode", 1, CPU, "int8",
                                       torch.bfloat16)
    four = cs.attention_work(args, True)[0]
    two = cs.attention_work(args, True, 2)[0]
    positions = sum(args["kv_lens"].tolist())
    assert four - two == positions * 2 * 2 * 2      # H 2, K and V


def test_weight_matmul_phase(plain_kernels, cpu_card, monkeypatch):
    model = TorchLM(*(lambda s: (s, init_lm_params(s, seed=0, device=CPU)))(
        ModelSpec(vocab=1024, d_model=64, num_layers=2, num_heads=2,
                  head_dim=32, max_seq_len=cs.GPT3_XL.max_seq_len)),
        device=CPU).quantize_weights()
    batches = [[(p[:len(p) // 4], sp) for p, sp in cs.requests_long(
        s, model.spec.vocab)] for s in (11, 13, 17)]
    res = cs.phase_weight_matmul(model, batches)
    assert res["launches"][i8.INT8_MATMUL_KERNEL] == \
        4 * res["launches"][pa.kernel_name(torch.int8, True)] > 0
    assert 0 < res["mae_vs_dequant"] <= cs.QUANT_MAE_MAX
    assert res["mae_vs_float"] <= cs.QUANT_MAE_MAX
    for wm in ("off", "int8"):
        assert res[wm]["ms_per_step"] > 0
        assert res[wm]["gemm_share"] is None     # no profiler on the CPU


def test_narrow_serving_phase(plain_kernels, cpu_card, monkeypatch):
    spec = ModelSpec(vocab=1024, d_model=64, num_layers=2, num_heads=2,
                     head_dim=32, max_seq_len=cs.GPT3_XL.max_seq_len)
    model = TorchLM(spec, init_lm_params(spec, seed=0, device=CPU),
                    device=CPU).quantize_weights()
    monkeypatch.setattr(cs, "LAUNCHES_BY_STEP", {})
    reqs = [(p[:len(p) // 4], sp) for p, sp in cs.requests_long(
        11, spec.vocab)]
    f32 = cs.drive_path("f32 scales", model, reqs,
                        pa.kernel_name(torch.int8, True),
                        cs.QuantConfig(kv="int8", weights="int8"), cs.SPLIT,
                        cs.CHUNK, min_prefix_pages=128 // cs.PAGE)[3]
    got = cs.phase_narrow_serving(model, reqs, f32, 128 // cs.PAGE)
    name = pa.kernel_name(torch.int8, True, torch.bfloat16)
    assert got["launches"][name] > 0
    assert got["same"] + got["ties"] == len(reqs)


def test_fabric_phase(plain_kernels, cpu_card, monkeypatch):
    model = TorchLM(*(lambda s: (s, init_lm_params(s, seed=0, device=CPU)))(
        ModelSpec(vocab=1024, d_model=64, num_layers=2, num_heads=2,
                  head_dim=32, max_seq_len=cs.GPT3_XL.max_seq_len)),
        device=CPU)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "FABRIC_BURST", 4)
    monkeypatch.setattr(cs, "FABRIC_PREFIX", 128)
    monkeypatch.setattr(cs, "FABRIC_KILL_STEP", 3)
    monkeypatch.setattr(cs, "FABRIC_FAULT_MS", 300)
    monkeypatch.setattr(cs, "FABRIC_ITL_MS", 250)
    res = cs.phase_fabric(model)
    assert res["kill"]["migrated"] >= 1
    assert res["disaggregated"]["handoff_pages"] > 0
    assert res["two"]["affinity_pages"] >= 0.9 * res["two"]["prefix_pages"]
    assert res["alerts"]["cleared_at"] > res["alerts"]["fired_at"]
    assert res["one"]["tokens_per_s"] > 0


def test_compare_routes_counts_ties_and_fails_the_rest():
    """``compare_routes`` (teacher-forced routes): equal outputs pass; a
    parting where the sampler on each route picks exactly its run's
    token, or where both tokens sit within twice the routes' difference
    of the best, counts as a near-tie; a parting the routes decide alike
    far from a tie fails, and so does a token that neither route picks
    and that sits far from the best. A sampled request must come with
    the seed it was served with."""
    V = 16
    clear = torch.zeros(1, V)
    clear[0, 3] = 5.0                                 # token 3 by 5.0
    close = clear.clone()
    close[0, 4] = 4.99                                # 3 over 4 by 0.01
    flipped = clear.clone()
    flipped[0, 4] = 5.5                               # 4 wins here
    reqs = [([1, 2], None)] * 3
    want = [[3, 3], [3, 3], [3, 3]]
    assert cs.compare_routes("same", reqs, want, want,
                             lambda ctx: (clear, clear)) == []
    got = [[3, 3], [3, 4], [3, 3]]
    ties = cs.compare_routes("apart", reqs, got, want,
                             lambda ctx: (flipped, clear))
    assert [(j, apart) for j, _, _, apart in ties] == [(1, True)]
    ties = cs.compare_routes("close", reqs, got, want,
                             lambda ctx: (close, close + 0.006))
    assert ties and not ties[0][3]
    with pytest.raises(AssertionError, match="not both within"):
        cs.compare_routes("far", reqs, got, want,
                          lambda ctx: (clear, clear + 1e-3))
    with pytest.raises(AssertionError, match="is 7"):
        cs.compare_routes("planted", reqs, [[3, 3], [3, 7], [3, 3]], want,
                          lambda ctx: (close, close + 0.006))
    sampled = [([1, 2], cs.SamplingParams(temperature=0.8, top_k=8))]
    with pytest.raises(ValueError, match="seed=None"):
        cs.compare_routes("unresolved", sampled, [[3, 4]], [[3, 3]],
                          lambda ctx: (close, close + 0.006))


def test_compare_tapped_judges_sampled_tokens_with_the_served_seed():
    """``compare_tapped`` (the fabric's check) on a sampled ``seed=None``
    request, judged with the seed the fabric drew for it: a parting
    where each run drew its token from its own logits, and the two
    runs' logits agree within the quantized-serving bar, passes; a
    planted token that its run's logits do not draw fails, and so do
    two runs whose logits are too far apart to be one context."""
    from paddle_tpu_torch.inference.llm.engine import resolve_sampling
    V = 64
    g = torch.Generator().manual_seed(3)
    sp = cs.SamplingParams(temperature=0.8, top_k=50, top_p=0.9)
    served = resolve_sampling(sp, np.random.default_rng(90210))
    assert served.seed is not None
    rows = [torch.randn(V, generator=g) for _ in range(2)]
    la = torch.randn(V, generator=g)
    lb = la.clone()
    pick = lambda lg, j: cs.pick_token(lg, served, j)  # noqa: E731
    while pick(lb, 2) == pick(la, 2):                 # the runs part
        lb = la + 0.05 * torch.randn(V, generator=g)
    prefix = [pick(rows[0], 0), pick(rows[1], 1)]
    got, want = [prefix + [pick(la, 2)]], [prefix + [pick(lb, 2)]]
    tap_got = _Tap({(served.seed, 0): rows[0], (served.seed, 1): rows[1],
                    (served.seed, 2): la})
    tap_want = _Tap({**tap_got.rows, (served.seed, 2): lb})
    reqs = [([1], served)]
    ties = cs.compare_tapped("served", reqs, got, want, tap_got, tap_want)
    assert [t[0] for t in ties] == [2] and ties[0][3] <= cs.QUANT_MAE_MAX
    wrong = int(cs.decision_scores(la, served, 2).argmin())
    with pytest.raises(AssertionError, match="logits draw"):
        cs.compare_tapped("planted", reqs, [prefix + [wrong]], want,
                          tap_got, tap_want)
    # every logit of the reference one higher: the same draws, but not
    # the same context
    with pytest.raises(AssertionError, match="not the same context"):
        cs.compare_tapped("far", reqs, got, [prefix + [pick(lb + 1.0, 2)]],
                          tap_got, _Tap({**tap_got.rows,
                                         (served.seed, 2): lb + 1.0}))
    with pytest.raises(ValueError, match="seed=None"):
        cs.compare_tapped("unresolved", [([1], sp)], got, want, tap_got,
                          tap_want)


def test_fabric_phase_fails_a_planted_token(plain_kernels, cpu_card,
                                            monkeypatch):
    """The fabric phase fails when the killed fabric's output of a
    sampled ``seed=None`` request carries a token that neither schedule
    picks with the seed the fabric drew."""
    model = TorchLM(*(lambda s: (s, init_lm_params(s, seed=0, device=CPU)))(
        ModelSpec(vocab=1024, d_model=64, num_layers=2, num_heads=2,
                  head_dim=32, max_seq_len=cs.GPT3_XL.max_seq_len)),
        device=CPU)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "FABRIC_BURST", 4)
    monkeypatch.setattr(cs, "FABRIC_PREFIX", 128)
    monkeypatch.setattr(cs, "FABRIC_KILL_STEP", 3)
    real = cs.run_fabric

    def planted(model, burst, **kw):
        out = real(model, burst, **kw)
        if kw.get("kill_at") is not None:
            k = 2
            assert burst[k][2].temperature > 0 and burst[k][2].seed is None
            tokens = out[2][k]
            tokens[-1] = (tokens[-1] + 512) % 1024
        return out

    monkeypatch.setattr(cs, "run_fabric", planted)
    with pytest.raises(AssertionError, match="killed vs unkilled"):
        cs.phase_fabric(model)

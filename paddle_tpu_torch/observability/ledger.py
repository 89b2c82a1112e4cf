"""Cost ledger & memory observatory (``observability.ledger``).

Counterpart of ``paddle_tpu/observability/ledger.py``.
:class:`StepLedger` models the HBM traffic and model FLOPs of every
dispatched step analytically, from the specs the engine already holds,
and attributes every byte and FLOP to a tenant with EXACT integer
accounting — the per-tenant sums always equal the engine totals. It is
the yardstick a roofline share is read against: modelled bytes of a
step over its measured device time, against the card's HBM rate.

The byte model of one step (all integers, the JAX ledger's):

- **weights**: every parameter streamed once per step —
  ``quant.modeled_weight_bytes(spec, quant)`` (int8 matmul weights
  cost 1 byte/element + float32 per-output-channel scale rows).
- **kv_read**: each row's page walk —
  ``pages_for(kv_len) x CacheConfig.page_bytes()`` (all layers, K+V,
  scale rows included) — plus the two-level table walk (one int32 per
  directory row + one per page index) and, when the flash-decode KV
  split is live, the combine pass's partial-state traffic: each of the
  row's ``ceil(pages / split_pages)`` chunks writes and the merge
  re-reads one f32 ``(m, l, acc)`` state per head per layer per query
  position.
- **kv_write**: each freshly appended K/V position —
  ``q_len x page_bytes / page_size``.
- **collective**: 0 — one card runs no collective.

The FLOP model per flat token: the per-layer Megatron quartet plus
the tied-embedding logits matmul (``2 x m x n x k`` each); attention
adds ``4 x H x D x q_len x kv_len`` per layer at the REAL ragged row
lengths.

The **compile observatory** rides the same object: every step dispatch
reports its graph lookup here (hit/miss counters whose miss sum is
``engine.xla_compiles``), and each CUDA graph capture its wall time
(``pd_compile_seconds{graph}``) and the peak device memory allocated
while capturing (``pd_compile_peak_bytes{graph}``). A miss beyond the
engine's ``graph_bound`` raises the recompile-storm counter + a
recorder warning. XLA's ``cost_analysis()`` / ``memory_analysis()``
cross-check of the model has no counterpart here: a graph capture
reports neither.

Ledger off (``PD_COST_LEDGER=0``) = the engine holds ``None``: one
branch per step, zero events, bit-exact outputs.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import ledger_metrics
from .metrics import Registry
from .recorder import default_recorder

__all__ = ["StepLedger", "integer_split"]


def integer_split(total: int, weights: List[int]) -> List[int]:
    """Split integer ``total`` proportionally to integer ``weights``
    with largest-remainder rounding: the shares are deterministic,
    non-negative, and sum to ``total`` EXACTLY — the primitive behind
    the ledger's tenant-sums-equal-engine-totals guarantee. All-zero
    weights put everything on the first entry."""
    n = len(weights)
    if n == 0:
        return []
    wsum = sum(weights)
    if wsum <= 0:
        return [total] + [0] * (n - 1)
    shares = [total * w // wsum for w in weights]
    short = total - sum(shares)
    # distribute the remainder by descending fractional part, index as
    # the deterministic tie-break
    order = sorted(range(n), key=lambda i: (-(total * weights[i] % wsum),
                                            i))
    for i in order[:short]:
        shares[i] += 1
    return shares


class StepLedger:
    """Per-engine analytic cost model + compile observatory.

    Construct via :meth:`for_engine`; the engine holds it as
    ``engine.ledger`` (``None`` = disabled, one branch per step) and
    calls :meth:`note_dispatch` at each step dispatch,
    :meth:`observe_capture` after each graph capture,
    :meth:`account_step` when a step's live rows land, and
    :meth:`observe_roofline` on sampled steps.
    """

    def __init__(self, spec, cache_config, quant=None,
                 bucket_bound: int = 0, kv_split_pages: int = 0,
                 registry: Optional[Registry] = None):
        # lazy import: observability must stay importable before (and
        # without) the inference stack
        from ..inference.llm.quant import modeled_weight_bytes

        self.spec = spec
        self._m = ledger_metrics(registry)
        self._rec = default_recorder()
        self.bucket_bound = int(bucket_bound)

        d = spec.d_model
        hd = spec.num_heads * spec.head_dim
        # ---- per-step / per-token byte constants ----
        self.weight_bytes = modeled_weight_bytes(spec, quant)
        self.page_bytes = int(cache_config.page_bytes())
        self.page_size = int(cache_config.page_size)
        # bytes one appended K/V position costs across all layers
        # (page_bytes already spans layers, K+V and scale rows)
        self.kv_write_bytes_tok = self.page_bytes // self.page_size
        self.coll_wire_bytes_tok = 0           # one card: no collective
        # ---- per-token FLOP constants (2*m*n*k per matmul) ----
        per_layer_mm = 2 * (d * 3 * hd + hd * d + d * 4 * d + 4 * d * d)
        self.flops_matmul_tok = (spec.num_layers * per_layer_mm
                                 + 2 * d * spec.vocab)     # tied LM head
        self.flops_attn_unit = 4 * spec.num_layers * hd    # x q_len x kv_len
        # ---- long-context terms ----
        # two-level table walk: one int32 per directory row touched
        # plus one per page index gathered (see kv_cache's slot_dir /
        # index_pool split)
        self.dir_fanout = int(cache_config.dir_fanout)
        # flash-decode KV split (PD_KV_SPLIT_PAGES, chunk size in
        # pages; 0 = off): a split row's combine pass writes, then the
        # merge re-reads, one f32 (m, l, acc) partial per chunk per
        # head per layer per query position — (head_dim + 2) floats
        self.kv_split_pages = max(int(kv_split_pages), 0)
        self.split_state_bytes_tok = (spec.num_layers * spec.num_heads
                                      * (spec.head_dim + 2) * 4)
        self.split_rows: Dict[int, int] = {}

        # ---- running totals (exact integers) ----
        self.total_hbm_bytes = 0
        self.total_flops = 0
        self.tenant_hbm_bytes: Dict[str, int] = {}
        self.tenant_flops: Dict[str, int] = {}
        self.component_bytes = {"weights": 0, "kv_read": 0,
                                "kv_write": 0, "collective": 0}
        self.steps_accounted = 0

        # ---- compile observatory state ----
        self.cache_hits: Dict[str, int] = {}
        self.cache_misses: Dict[str, int] = {}
        self.step_misses = 0           # "step"-kind misses vs the bound
        self.storms = 0
        # (kind, bucket, tile rows) -> {"compile_seconds",
        # "peak_bytes", "added_bytes"} of that signature's capture
        self.captures: Dict[Tuple[str, int, bool], dict] = {}

        # pre-bind every family at 0 so an export shows the catalog
        # before the first step or capture
        self._m["hbm_bytes"].labels(tenant="default")
        self._m["model_flops"].labels(tenant="default")
        for c in ("weights", "kv_read", "kv_write", "collective"):
            self._m["bytes_component"].labels(component=c)
        self._m["prefix_saved"].inc(0)
        for kind in ("step",):
            self._m["compile_s"].labels(graph=kind)
            self._m["compile_peak_bytes"].labels(graph=kind).set(0)
            for ev in ("hit", "miss"):
                self._m["compile_cache"].labels(graph=kind, event=ev)
        self._m["compile_storms"].inc(0)
        self._m["kv_tenant_pages"].labels(tenant="default").set(0)
        self._m["kv_split_rows"].labels(split="1")
        self._m["longest_kv"].set(0)
        self._m["longest_split"].set(0)
        for g in ("roofline_flops_per_s", "roofline_bytes_per_s",
                  "roofline_intensity"):
            self._m[g].labels(bucket="0").set(0)

    @classmethod
    def for_engine(cls, engine) -> "StepLedger":
        """Bind a ledger to a constructed engine: spec, cache config,
        quant switches and the engine's bound on step signatures all
        come from the engine itself."""
        return cls(engine.model.spec, engine.cache.config,
                   quant=engine.quant, bucket_bound=engine.graph_bound,
                   kv_split_pages=getattr(engine, "_kv_split_pages", 0),
                   registry=engine.obs_registry)

    # ------------------------------------------------ compile observatory --
    def note_dispatch(self, kind: str, miss: bool, bucket: int) -> None:
        """One step-graph lookup: ``miss`` is 'this engine has not
        launched this step signature before' — exactly the condition
        that grows ``engine._graphs``, so the per-kind miss sum equals
        ``engine.xla_compiles`` by construction."""
        ev = "miss" if miss else "hit"
        book = self.cache_misses if miss else self.cache_hits
        book[kind] = book.get(kind, 0) + 1
        self._m["compile_cache"].labels(graph=kind, event=ev).inc()
        if miss and kind == "step":
            self.step_misses += 1
            if self.step_misses > self.bucket_bound > 0:
                # more step signatures than the engine's bound:
                # something is varying a shape that should not vary
                self.storms += 1
                self._m["compile_storms"].inc()
                self._rec.emit("engine", "recompile_storm", kind=kind,
                               bucket=bucket, compiles=self.step_misses,
                               bound=self.bucket_bound)

    def observe_capture(self, kind: str, bucket: int, seconds: float,
                        peak_bytes: int, added_bytes: int = 0,
                        tiles: bool = True) -> dict:
        """One CUDA graph capture of ``bucket``'s step (with or without
        tile rows): its wall time into ``pd_compile_seconds{graph}``,
        the process's peak allocated device memory as of the capture
        (``torch.cuda.max_memory_allocated``) into
        ``pd_compile_peak_bytes``, and the memory the capture added to
        the graphs' pool (``added_bytes``) into :attr:`captures`."""
        info = {"compile_seconds": float(seconds),
                "peak_bytes": int(peak_bytes),
                "added_bytes": int(added_bytes)}
        self.captures[(kind, int(bucket), bool(tiles))] = info
        self._m["compile_s"].labels(graph=kind).observe(float(seconds))
        self._m["compile_peak_bytes"].labels(graph=kind).set(
            float(peak_bytes))
        self._rec.emit("engine", "compile", graph=kind, bucket=bucket,
                       tiles=bool(tiles), seconds=round(float(seconds), 6),
                       peak_bytes=int(peak_bytes),
                       added_bytes=int(added_bytes))
        return info

    # ------------------------------------------------ analytic cost model --
    def split_factor(self, kv_len: int) -> int:
        """Flash-decode split factor of one row: how many KV chunks its
        page walk shards into — ``ceil(pages / split_pages)``, 1 with
        the knob off or when the row fits one chunk. This is the
        ``split`` label of ``pd_kv_split_rows_total``."""
        if self.kv_split_pages <= 0:
            return 1
        pages = -(-max(kv_len, 1) // self.page_size)
        return max(-(-pages // self.kv_split_pages), 1)

    def _row_kv_read(self, q_len: int, pages: int, split: int) -> int:
        """One row's kv_read bytes: the page walk itself, the
        two-level table walk (directory rows + page indices, int32
        each), and — only when the row actually splits — the combine
        pass's partial-state write + merge re-read."""
        walk = (pages + -(-pages // self.dir_fanout)) * 4
        partial = (2 * split * q_len * self.split_state_bytes_tok
                   if split > 1 else 0)
        return pages * self.page_bytes + walk + partial

    def modeled_row_cost(self, q_len: int, kv_len: int) -> Tuple[int, int]:
        """(hbm_bytes, flops) of ONE row at its REAL ragged lengths —
        weight traffic excluded (that is a step-wide cost split across
        rows by :meth:`account_step`)."""
        pages = -(-max(kv_len, 1) // self.page_size)
        row_bytes = (self._row_kv_read(q_len, pages,
                                       self.split_factor(kv_len))
                     + q_len * self.kv_write_bytes_tok
                     + q_len * self.coll_wire_bytes_tok)
        row_flops = (q_len * self.flops_matmul_tok
                     + self.flops_attn_unit * q_len * kv_len)
        return row_bytes, row_flops

    def account_step(self, rows: List[tuple]) -> Tuple[int, int]:
        """Land one step's live rows into the ledger. ``rows`` is a
        list of ``(request, q_len, kv_len)``. Row-derived costs go to
        the row's tenant (and request) directly; the step-wide weight
        stream is split across rows by flat tokens with
        :func:`integer_split` — so tenant sums equal engine totals
        EXACTLY, no floats anywhere. Returns the step's
        ``(hbm_bytes, flops)`` for the roofline join."""
        if not rows:
            return 0, 0
        w_shares = integer_split(self.weight_bytes,
                                 [int(q) for _, q, _ in rows])
        step_bytes = step_flops = 0
        by_tenant_b: Dict[str, int] = {}
        by_tenant_f: Dict[str, int] = {}
        kv_read = kv_write = coll = 0
        n_split = max_split = longest_kv = 0
        for (req, q_len, kv_len), w in zip(rows, w_shares):
            q_len, kv_len = int(q_len), int(kv_len)
            row_bytes, row_flops = self.modeled_row_cost(q_len, kv_len)
            pages = -(-max(kv_len, 1) // self.page_size)
            split = self.split_factor(kv_len)
            self.split_rows[split] = self.split_rows.get(split, 0) + 1
            self._m["kv_split_rows"].labels(split=str(split)).inc()
            if split > 1:
                n_split += 1
                max_split = max(max_split, split)
            longest_kv = max(longest_kv, kv_len)
            kv_read += self._row_kv_read(q_len, pages, split)
            kv_write += q_len * self.kv_write_bytes_tok
            coll += q_len * self.coll_wire_bytes_tok
            row_bytes += w
            tenant = getattr(req, "tenant", "default")
            by_tenant_b[tenant] = by_tenant_b.get(tenant, 0) + row_bytes
            by_tenant_f[tenant] = by_tenant_f.get(tenant, 0) + row_flops
            if req is not None:
                req.cost_hbm_bytes += row_bytes
                req.cost_flops += row_flops
            step_bytes += row_bytes
            step_flops += row_flops
        for t, b in by_tenant_b.items():
            self.tenant_hbm_bytes[t] = self.tenant_hbm_bytes.get(t, 0) + b
            self._m["hbm_bytes"].labels(tenant=t).inc(b)
        for t, f in by_tenant_f.items():
            self.tenant_flops[t] = self.tenant_flops.get(t, 0) + f
            self._m["model_flops"].labels(tenant=t).inc(f)
        self.total_hbm_bytes += step_bytes
        self.total_flops += step_flops
        self.component_bytes["weights"] += self.weight_bytes
        self.component_bytes["kv_read"] += kv_read
        self.component_bytes["kv_write"] += kv_write
        self.component_bytes["collective"] += coll
        cb = self._m["bytes_component"]
        cb.labels(component="weights").inc(self.weight_bytes)
        cb.labels(component="kv_read").inc(kv_read)
        cb.labels(component="kv_write").inc(kv_write)
        if coll:
            cb.labels(component="collective").inc(coll)
        self._m["longest_kv"].set(longest_kv)
        self._m["longest_split"].set(self.split_factor(longest_kv))
        if n_split:
            self._rec.emit("engine", "kv_split", rows=n_split,
                           max_split=max_split,
                           split_pages=self.kv_split_pages)
        self.steps_accounted += 1
        return step_bytes, step_flops

    def observe_roofline(self, bucket: int, step_bytes: int,
                         step_flops: int, device_seconds: float,
                         tenant_pages: Optional[Dict[str, int]] = None
                         ) -> None:
        """Join one FENCED step's modeled costs with its measured
        device span: achieved FLOP/s, bytes/s and arithmetic intensity
        per bucket — the roofline coordinates the on-device campaign
        will correlate against. Also refreshes the per-tenant resident
        KV page gauge (fenced cadence keeps it one dict walk per
        sample, not per step)."""
        if device_seconds > 0:
            b = str(int(bucket))
            self._m["roofline_flops_per_s"].labels(bucket=b).set(
                step_flops / device_seconds)
            self._m["roofline_bytes_per_s"].labels(bucket=b).set(
                step_bytes / device_seconds)
            if step_bytes > 0:
                self._m["roofline_intensity"].labels(bucket=b).set(
                    step_flops / step_bytes)
        if tenant_pages:
            for t, pages in tenant_pages.items():
                self._m["kv_tenant_pages"].labels(tenant=t).set(
                    int(pages))

    # ----------------------------------------------------------- summary --
    def summary(self) -> dict:
        """Plain str/int/float snapshot of the ledger —
        ``serving.engine_cost_summary`` JSON-bridges exactly this."""
        return {
            "total_hbm_bytes": self.total_hbm_bytes,
            "total_flops": self.total_flops,
            "steps_accounted": self.steps_accounted,
            "weight_bytes_per_step": self.weight_bytes,
            "page_bytes": self.page_bytes,
            "coll_wire_bytes_per_token": self.coll_wire_bytes_tok,
            "tenant_hbm_bytes": dict(self.tenant_hbm_bytes),
            "tenant_flops": dict(self.tenant_flops),
            "component_bytes": dict(self.component_bytes),
            "kv_split_pages": self.kv_split_pages,
            "kv_split_rows": {str(k): v
                              for k, v in sorted(self.split_rows.items())},
            "compile_cache_hits": dict(self.cache_hits),
            "compile_cache_misses": dict(self.cache_misses),
            "recompile_storms": self.storms,
            "captures": {f"{kind}:{bucket}:{'tiles' if tiles else 'decode'}":
                         dict(info) for (kind, bucket, tiles), info
                         in sorted(self.captures.items())},
        }

"""Step-phase profiler: where does one engine step's wall time go?

Counterpart of ``paddle_tpu/observability/stepprof.py``. Every
``GenerationEngine.step`` is decomposed into named HOST phases:

    fault_delay      chaos-harness injected step delay (PD_FAULT_DELAY_*
                     — tagged so injected stalls never masquerade as
                     device_wait or corrupt device-idle accounting)
    deadline_sweep   expire TTFT/total deadlines (scheduler)
    plan             admission scan + mixed-step row packing policy
    draft            n-gram draft proposals (host-side speculation)
    pack             flat ragged-block assembly + host->device staging
    dispatch         the step's launch or graph replay returning
    device_wait      waiting on the step's results (its event)
    sample_commit    landing sampled tokens: scheduler state, EOS,
                     rollback, per-request bookkeeping
    page_bookkeeping KV-pool invariant audit + page accounting

**Where the device time comes from.** The JAX profiler fences a sampled
step (``block_until_ready`` bracketing) and watches completions from a
thread. The port needs neither: on the card the engine records a
``torch.cuda.Event`` on its stream before each step's device work (its
input copies) and one after it (its result copies), around the eager
step or around ``graph.replay()``, never inside a captured region. Once
the step commits, its events have completed and the engine reports

- busy(N) = start(N).elapsed_time(end(N)), and
- idle(N) = end(N-1).elapsed_time(start(N)) — the device-side gap
  between consecutive steps, ``max(0, enqueue(N) - done(N-1))`` of the
  JAX profiler's overlap-aware accounting, without a host fence: zero
  when step N was queued before N-1 finished (the pipelined steady
  state), the host's lateness otherwise,

through :meth:`StepProfiler.device_span`. The pipeline is never
drained for a measurement, so the port's step counts are the same with
the profiler on and off. The sampled ("fenced") steps, every
``round(1/ratio)``-th (``PD_OBS_STEPPROF_SAMPLE``, default
``policy.STEPPROF_SAMPLE_PCT`` percent), carry their event-timed busy
span into their :class:`StepRecord` and the fenced-step gauges. On
the CPU the step has run when its dispatch returns, so the engine laps
``perf_counter`` around it (:meth:`StepProfiler.device_gap`), as the
JAX profiler does without a device.

Three consumers, one record stream:

- **metrics**: ``pd_step_phase_seconds{phase}`` histograms,
  ``pd_device_idle_per_token_seconds`` and ``pd_host_overhead_ratio``
  gauges, ``pd_stepprof_fenced_steps_total``.
- **flight recorder / Chrome trace**: each lap emits a ``phase``-track
  slice and each fenced step a ``device``-track ``device_busy`` slice.
- **per-step records**: a bounded ring of :class:`StepRecord`
  (phase durations, ragged tokens, rows by kind, bucket, device time,
  steps committed) behind ``records()`` / ``summary()``.

Alongside lives the **SLO digest**: true streaming percentiles
(p50/p90/p99) of TTFT, inter-token latency and queue wait keyed by
``{tenant, priority}``, exact over a bounded sliding window, published
into ``pd_slo_*`` gauges lazily at export time (a collect hook), so the
serving hot path never pays for percentile math.

Cost contract (same as the registry/recorder): disabled —
``PD_OBS_STEPPROF=0``, ``obs.disable()`` or ``PD_OBS_DISABLED=1`` —
makes ``begin_step`` set one flag and every other call one attribute
load + one branch. Enabled, a step costs ~8 ``perf_counter`` laps +
one dict each, plus one more event record on the card.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

from .export import register_collect_hook
from .metrics import Registry, default_registry, log_buckets
from .recorder import FlightRecorder, default_recorder

__all__ = ["PHASES", "StepRecord", "StepProfiler", "step_metrics",
           "QuantileDigest", "SLODigest", "SLO_QUANTILES",
           "default_slo_digest", "set_default_slo_digest",
           "default_sample"]

PHASES = ("fault_delay", "deadline_sweep", "plan", "draft", "pack",
          "dispatch", "device_wait", "sample_commit", "page_bookkeeping")

# phase durations live in the 1us..ms range — the serving latency
# buckets (100us floor) would flatten them into two buckets
PHASE_BUCKETS = log_buckets(1e-6, 1.0, 2.0)


def default_sample() -> float:
    """Sampling ratio: ``PD_OBS_STEPPROF_SAMPLE`` (float, 0 samples no
    step), else ``policy.STEPPROF_SAMPLE_PCT`` (integer percent)."""
    env = os.environ.get("PD_OBS_STEPPROF_SAMPLE")
    if env is not None:
        try:
            return max(float(env), 0.0)
        except ValueError:
            pass
    # lazy: observability must not import inference at module load
    from ..inference.llm.policy import STEPPROF_SAMPLE_PCT
    return max(STEPPROF_SAMPLE_PCT, 0) / 100.0


class StepRecord(NamedTuple):
    """One profiled engine step."""

    ts: float                       # perf_counter at step start
    dur: float                      # step wall time, seconds
    kind: str                       # plan kind: mixed/prefill/decode/idle
    phases: Dict[str, float]        # phase -> seconds (missing = not hit)
    tokens: int                     # ragged tokens packed
    chunk_rows: int
    decode_rows: int
    verify_rows: int
    bucket: int                     # ragged-token bucket dispatched
    tokens_out: int                 # tokens actually delivered
    fenced: bool                    # device time recovered this step?
    device_s: Optional[float]       # fenced: the step's event-timed span
    device_idle_s: Optional[float]  # fenced: max(dur - device_s, 0)
    commits: int = 0                # steps committed during this call

    def to_dict(self) -> dict:
        d = self._asdict()
        d["phases"] = dict(self.phases)
        return d


def step_metrics(registry: Optional[Registry] = None) -> dict:
    """Create-or-get the step-profiler metric families (idempotent)."""
    r = registry or default_registry()
    return {
        "phase": r.histogram(
            "pd_step_phase_seconds",
            "host wall time of one engine step's named phase "
            "(fault_delay/deadline_sweep/plan/draft/pack/dispatch/"
            "device_wait/sample_commit/page_bookkeeping)",
            labelnames=("phase",), buckets=PHASE_BUCKETS),
        "device_idle": r.gauge(
            "pd_device_idle_per_token_seconds",
            "host-side seconds the device sat idle per delivered token "
            "(cumulative over fenced steps; the async-scheduling PR "
            "must drive this to ~0)"),
        "host_ratio": r.gauge(
            "pd_host_overhead_ratio",
            "fraction of step wall time the device was idle (host-only "
            "work on the critical path; cumulative over fenced steps)"),
        "fenced": r.counter(
            "pd_stepprof_fenced_steps_total",
            "sampled steps whose event-timed device span entered the "
            "step records"),
    }


class StepProfiler:
    """Per-engine phase clock. The engine calls ``begin_step`` /
    ``lap(phase)`` / ``end_step``; ``fence`` says whether THIS step is
    one of the sampled ones whose device span the engine reports via
    :meth:`device` when the step commits."""

    def __init__(self, registry: Optional[Registry] = None,
                 recorder: Optional[FlightRecorder] = None,
                 sample: Optional[float] = None,
                 capacity: Optional[int] = None,
                 enabled: Optional[bool] = None):
        self._registry = registry or default_registry()
        self._rec = recorder or default_recorder()
        sample = default_sample() if sample is None else max(sample, 0.0)
        self.sample = sample
        # deterministic sampling: fence every round(1/ratio)-th step
        # (ratio 0 -> never; the FIRST step is always in the sample so
        # short runs still get one device measurement)
        self._period = (0 if sample <= 0.0
                        else max(1, int(round(1.0 / min(sample, 1.0)))))
        if capacity is None:
            capacity = int(os.environ.get("PD_OBS_STEPPROF_CAPACITY",
                                          "2048"))
        self._records: deque = deque(maxlen=max(capacity, 16))
        if enabled is None:
            enabled = os.environ.get(
                "PD_OBS_STEPPROF", "1").lower() not in ("0", "false",
                                                        "off")
        self._enabled = bool(enabled)
        self._m = step_metrics(self._registry)
        for ph in PHASES:   # pre-bind: the catalog exports at zero
            self._m["phase"].labels(phase=ph)
        self._active = False
        self._fenced = False
        self._step_i = 0
        # cumulative device accounting (fenced steps only)
        self.fenced_steps = 0
        self._device_s_total = 0.0
        self._idle_s_total = 0.0
        self._wall_s_total = 0.0
        self._tokens_out_total = 0
        # ---- overlap-aware accounting (async pipelining) ----
        # gap totals: device idle/busy of consecutive steps, from the
        # engine's step events on the card (device_span) or its host
        # clock on the CPU (device_gap), in both modes; the engine
        # thread is the one writer, so plain floats.
        self._overlap = False
        self._t_prev_done: Optional[float] = None
        self._gap_idle_total = 0.0
        self._gap_busy_total = 0.0
        self._gap_steps = 0
        self._gap_tokens_total = 0
        # every committed step's device span, the chain's first step
        # included (which the gap totals, as pairs, leave out)
        self._busy_total = 0.0
        self._busy_steps = 0
        # bounded per-step (gap, busy) samples: medians over these are
        # immune to the throttle spikes that dominate any mean on a
        # shared host
        self._gap_ring: deque = deque(maxlen=max(capacity, 16))
        # the same samples keyed by pipeline occupancy at enqueue time
        # (0 = serial / filling, D = full D-deep pipeline): a depth-2
        # engine whose depth-tagged medians are flat-zero at occupancy
        # 2 but nonzero at 0 is spending its life refilling — exactly
        # the shape gap_depth_profile() makes visible
        self._gap_rings_by_depth: Dict[int, deque] = {}
        self._gap_ring_cap = max(capacity, 16)
        # an injectable clock (tests); perf_counter by default
        self.clock = time.perf_counter

    # ------------------------------------------------------------ state --
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    # ------------------------------------------------------- step clock --
    def begin_step(self) -> None:
        if not (self._enabled and self._registry.enabled):
            self._active = False      # every later call: one branch
            return
        self._active = True
        self._fenced = (self._period > 0
                        and self._step_i % self._period == 0)
        self._step_i += 1
        self._phases: Dict[str, float] = {}
        self._attrs: Dict[str, int] = {}
        self._device: Optional[Tuple[float, float]] = None
        self._t0 = self._t_last = self.clock()

    @property
    def active(self) -> bool:
        """True between ``begin_step`` and ``end_step`` of an enabled
        profiler: the engine records its step events only then."""
        return self._active

    @property
    def fence(self) -> bool:
        """True when THIS step is in the sample: the engine reports its
        event-timed span via :meth:`device` when it commits (the port
        never drains the pipeline for it)."""
        return self._active and self._fenced

    def lap(self, phase: str) -> None:
        """Attribute the time since the last lap to ``phase``."""
        if not self._active:
            return
        now = self.clock()
        dt = now - self._t_last
        self._t_last = now
        self._phases[phase] = self._phases.get(phase, 0.0) + dt
        # the host phase train as its own Chrome-trace track
        self._rec.emit("phase", phase, ts=now - dt, dur=dt)

    def annotate(self, **attrs: int) -> None:
        """Attach step shape facts (tokens, rows by kind, bucket,
        tokens_out) to the record under construction."""
        if self._active:
            self._attrs.update(attrs)

    def device(self, t_start: float, dur: float) -> None:
        """Report a sampled step's device span (engine-measured)."""
        if self._active:
            self._device = (t_start, dur)

    # --------------------------------------- overlap-aware accounting --
    @property
    def overlap_mode(self) -> bool:
        return self._overlap

    def set_overlap(self, on: bool) -> None:
        """Pipelined engines (async_depth > 0) switch the device-idle
        gauge and properties to the gap-based totals; fence-based
        wall-minus-busy would double-count overlapped device time."""
        self._overlap = bool(on)

    def _note_gap(self, gap: float, busy: float, depth: int = 0) -> None:
        """Chain one step's device (gap, busy) pair into the gap
        totals: idle = time the device sat between the previous step
        finishing and this one starting (0 when it was pre-enqueued —
        the pipelined steady state); busy = this step's device span.
        ``depth`` tags the sample with the pipeline occupancy the engine
        saw when it dispatched this step (per-depth ring)."""
        self._gap_idle_total += gap
        self._gap_busy_total += busy
        self._note_busy(busy)
        self._gap_ring.append((gap, busy))
        d = max(int(depth), 0)
        ring = self._gap_rings_by_depth.get(d)
        if ring is None:
            ring = self._gap_rings_by_depth.setdefault(
                d, deque(maxlen=self._gap_ring_cap))
        ring.append((gap, busy))
        self._gap_steps += 1
        if self._overlap:
            self._publish_gap_gauges()

    def _note_busy(self, busy: float) -> None:
        self._busy_total += busy
        self._busy_steps += 1

    def _publish_gap_gauges(self) -> None:
        if self._gap_tokens_total:
            self._m["device_idle"].set(self._gap_idle_total
                                       / self._gap_tokens_total)
        denom = self._gap_idle_total + self._gap_busy_total
        if denom:
            self._m["host_ratio"].set(self._gap_idle_total / denom)

    def device_gap(self, t_start: float, t_done: float,
                   depth: int = 0) -> None:
        """Host-clock reporting (the CPU, where a step has run when its
        dispatch returns): the (start, done) pair of each step IS the
        device timeline; the first step only sets the chain."""
        if not (self._enabled and self._registry.enabled):
            return
        prev = self._t_prev_done
        self._t_prev_done = t_done
        if prev is not None:
            self._note_gap(max(t_start - prev, 0.0),
                           max(t_done - max(prev, t_start), 0.0), depth)
        else:
            self._note_busy(max(t_done - t_start, 0.0))

    def device_span(self, gap_s: Optional[float], busy_s: float,
                    depth: int = 0) -> None:
        """Event-timed reporting (the card): after step N committed,
        ``gap_s`` = end(N-1).elapsed_time(start(N)) and ``busy_s`` =
        start(N).elapsed_time(end(N)), in seconds, from the events
        recorded around N's device work on the engine's stream (``gap_s``
        None for a step with no predecessor: its span goes into the busy
        totals of :meth:`summary` only, the gap chain skips it).
        ``depth`` = pipeline occupancy when N was dispatched."""
        if not (self._enabled and self._registry.enabled):
            return
        if gap_s is None:
            self._note_busy(max(float(busy_s), 0.0))
            return
        self._note_gap(max(float(gap_s), 0.0), max(float(busy_s), 0.0),
                       depth)

    def note_tokens(self, n: int) -> None:
        """Delivered-token count for the gap-based idle-per-token
        denominator (the engine reports it at each commit)."""
        if not (self._enabled and self._registry.enabled) or n <= 0:
            return
        self._gap_tokens_total += n
        if self._overlap:
            self._publish_gap_gauges()

    @property
    def gap_idle_per_token_s(self) -> Optional[float]:
        """Gap-accounted device idle per delivered token — recorded in
        both modes, so a serial baseline and a pipelined run compare on
        one scale."""
        if not self._gap_tokens_total:
            return None
        return self._gap_idle_total / self._gap_tokens_total

    @property
    def gap_median_idle_s(self) -> Optional[float]:
        """MEDIAN per-dispatch device-idle gap: the robust readout of
        "was the next step queued before the last one finished" — a
        handful of scheduler/throttle spikes cannot move it, unlike the
        per-token mean."""
        # a scrape may read while the engine appends; copying a deque
        # another thread mutates can raise RuntimeError (same race
        # QuantileDigest._sorted_window handles) — retry, and answer
        # from whatever the final attempt yields
        for _ in range(8):
            try:
                gaps = sorted(g for g, _ in tuple(self._gap_ring))
                break
            except RuntimeError:    # deque mutated during iteration
                continue
        else:
            return None
        return gaps[len(gaps) // 2] if gaps else None

    def gap_depth_profile(self) -> Dict[int, Dict[str, float]]:
        """Per-pipeline-occupancy gap readout:
        ``{depth: {"median_idle_s", "samples"}}`` over each depth's
        bounded ring. Depth = in-flight count when the dispatch was
        enqueued (0 = serial or refilling, D = full pipeline), so a
        deep-async engine shows WHERE its idle lives: gaps at
        occupancy D mean the device outran a full pipeline; gaps at 0
        mean the pipeline never filled. Same mutating-deque retry as
        :attr:`gap_median_idle_s`."""
        out: Dict[int, Dict[str, float]] = {}
        for d in sorted(self._gap_rings_by_depth):
            ring = self._gap_rings_by_depth[d]
            for _ in range(8):
                try:
                    gaps = sorted(g for g, _ in tuple(ring))
                    break
                except RuntimeError:    # appended during iteration
                    continue
            else:
                continue
            if gaps:
                out[d] = {"median_idle_s": gaps[len(gaps) // 2],
                          "samples": float(len(gaps))}
        return out

    @property
    def gap_tokens_per_step(self) -> Optional[float]:
        if not self._gap_steps:
            return None
        return self._gap_tokens_total / self._gap_steps

    def end_step(self, kind: str = "step") -> None:
        if not self._active:
            return
        self._active = False
        now = self.clock()
        wall = now - self._t0
        phases = self._phases
        fam = self._m["phase"]
        for name, dur in phases.items():
            fam.labels(phase=name).observe(dur)
        a = self._attrs
        tokens_out = int(a.get("tokens_out", 0))
        # overlap mode: the committing step's wall covers a DIFFERENT
        # dispatch's execution, so a device sample can arrive on a step
        # that is not itself in the fence sample (the engine fenced the
        # dispatch, the commit landed later) — accept it, but leave the
        # wall-minus-busy idle math to the gap accounting
        fenced = self._device is not None and (self._fenced
                                               or self._overlap)
        device_s = idle_s = None
        if fenced:
            t_d0, device_s = self._device
            self.fenced_steps += 1
            self._device_s_total += device_s
            self._m["fenced"].inc()
            if not self._overlap:
                idle_s = max(wall - device_s, 0.0)
                self._idle_s_total += idle_s
                self._wall_s_total += wall
                self._tokens_out_total += max(tokens_out, 0)
                if self._tokens_out_total:
                    self._m["device_idle"].set(self._idle_s_total
                                               / self._tokens_out_total)
                if self._wall_s_total:
                    self._m["host_ratio"].set(self._idle_s_total
                                              / self._wall_s_total)
            # the device lane: gaps between these slices = idle
            self._rec.emit("device", "device_busy", ts=t_d0, dur=device_s)
        self._records.append(StepRecord(
            ts=self._t0, dur=wall, kind=kind, phases=dict(phases),
            tokens=int(a.get("tokens", 0)),
            chunk_rows=int(a.get("chunk_rows", 0)),
            decode_rows=int(a.get("decode_rows", 0)),
            verify_rows=int(a.get("verify_rows", 0)),
            bucket=int(a.get("bucket", 0)), tokens_out=tokens_out,
            fenced=fenced, device_s=device_s, device_idle_s=idle_s,
            commits=int(a.get("commits", 0))))

    # ----------------------------------------------------------- query --
    def __len__(self) -> int:
        return len(self._records)

    def records(self, last: Optional[int] = None) -> List[StepRecord]:
        recs = list(self._records)
        return recs[-last:] if last else recs

    def last_record(self) -> Optional[StepRecord]:
        return self._records[-1] if self._records else None

    @property
    def device_idle_per_token_s(self) -> Optional[float]:
        if self._overlap:
            return self.gap_idle_per_token_s
        if not self._tokens_out_total:
            return None
        return self._idle_s_total / self._tokens_out_total

    @property
    def host_overhead_ratio(self) -> Optional[float]:
        if self._overlap:
            denom = self._gap_idle_total + self._gap_busy_total
            return (self._gap_idle_total / denom) if denom else None
        if not self._wall_s_total:
            return None
        return self._idle_s_total / self._wall_s_total

    def summary(self) -> dict:
        """Aggregate view over the record ring."""
        recs = list(self._records)
        per_phase: Dict[str, float] = {}
        for r in recs:
            for ph, dur in r.phases.items():
                per_phase[ph] = per_phase.get(ph, 0.0) + dur
        wall = sum(r.dur for r in recs)
        return {
            "steps": len(recs),
            "commits": sum(r.commits for r in recs),
            "fenced_steps": self.fenced_steps,
            "wall_s": wall,
            "tokens": sum(r.tokens for r in recs),
            "tokens_out": sum(r.tokens_out for r in recs),
            "phase_s": per_phase,
            "phase_share": ({ph: v / wall for ph, v in per_phase.items()}
                            if wall else {}),
            "device_idle_per_token_s": self.device_idle_per_token_s,
            "host_overhead_ratio": self.host_overhead_ratio,
            "overlap_mode": self._overlap,
            "gap_steps": self._gap_steps,
            "gap_idle_per_token_s": self.gap_idle_per_token_s,
            "gap_median_idle_s": self.gap_median_idle_s,
            "gap_busy_s": self._gap_busy_total,
            "gap_idle_s": self._gap_idle_total,
            # the device span of every committed step (the gap chain's
            # first step included): device time per step reads these
            "device_busy_s": self._busy_total,
            "device_busy_steps": self._busy_steps,
            "idle_share": (self._gap_idle_total
                           / (self._gap_idle_total + self._gap_busy_total)
                           if self._gap_idle_total + self._gap_busy_total
                           else None),
        }


# ---------------------------------------------------------------------------
# SLO digest: true streaming percentiles keyed by {tenant, priority}
# ---------------------------------------------------------------------------

SLO_QUANTILES = ((0.5, "p50"), (0.9, "p90"), (0.99, "p99"))

_SLO_FAMILIES = {
    "ttft": ("pd_slo_ttft_seconds",
             "submit -> first token, true percentile over the digest "
             "window (not bucket-interpolated)"),
    "itl": ("pd_slo_itl_seconds",
            "inter-token latency (gap between consecutive delivered "
            "tokens of one request), true percentile over the digest "
            "window"),
    "queue_wait": ("pd_slo_queue_wait_seconds",
                   "submit -> admission, true percentile over the "
                   "digest window"),
}


class QuantileDigest:
    """Bounded sliding-window digest: the last ``capacity``
    observations verbatim, with EXACT numpy-style (linear
    interpolation) percentiles over that window. For workloads shorter
    than the window the readout equals ``np.percentile`` on the full
    stream; past it, the digest answers for the most recent window —
    the right bias for a live SLO readout."""

    __slots__ = ("_ring",)

    def __init__(self, capacity: int = 4096):
        self._ring: deque = deque(maxlen=max(capacity, 2))

    def observe(self, value: float) -> None:
        self._ring.append(float(value))     # deque append: atomic, no lock

    def __len__(self) -> int:
        return len(self._ring)

    def _sorted_window(self) -> List[float]:
        """Sorted copy of the window, safe against a concurrent
        observe(): copying a deque another thread appends to can raise
        RuntimeError (same race recorder.snapshot handles) — retry,
        and return whatever the final attempt yields."""
        for _ in range(8):
            try:
                return sorted(self._ring)
            except RuntimeError:    # deque mutated during iteration
                continue
        return []

    @staticmethod
    def _interp(vals: List[float], q: float) -> float:
        pos = q * (len(vals) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(vals) - 1)
        return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)

    def quantile(self, q: float) -> Optional[float]:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        vals = self._sorted_window()
        return self._interp(vals, q) if vals else None

    def quantiles(self, qs) -> List[Optional[float]]:
        """Several quantiles from ONE sort of the window (what the
        per-scrape publish path uses)."""
        vals = self._sorted_window()
        if not vals:
            return [None] * len(qs)
        for q in qs:
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"quantile must be in [0, 1], got {q}")
        return [self._interp(vals, q) for q in qs]

    def values(self) -> List[float]:
        """The raw window in arrival order (oldest first), with the
        same retry-on-concurrent-append discipline as
        :meth:`_sorted_window`. This is what exact cross-replica digest
        merging consumes: re-observing N replicas' windows into one
        digest keeps percentiles exact (numpy over the concatenation),
        where quantile-of-quantiles would not, and burn-rate evaluation
        needs the arrival order to carve its fast sub-window."""
        for _ in range(8):
            try:
                return list(self._ring)
            except RuntimeError:    # deque mutated during iteration
                continue
        return []


class SLODigest:
    """Per-{tenant, priority} sliding-window percentile digests for
    TTFT, inter-token latency and queue wait. ``observe`` is the hot
    path: one enabled-branch + one dict lookup + one deque append.
    ``publish`` renders p50/p90/p99 into ``pd_slo_*`` gauges — called
    lazily by the exporters (collect hook), never per token."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self._capacity = capacity
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        self._digests: Dict[Tuple[str, str, str], QuantileDigest] = {}

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def observe(self, metric: str, tenant: str, priority,
                value: float) -> None:
        if not self._enabled:
            return
        key = (metric, str(tenant), str(priority))
        d = self._digests.get(key)
        if d is None:
            with self._lock:
                d = self._digests.setdefault(key,
                                             QuantileDigest(self._capacity))
        d.observe(value)

    def quantile(self, metric: str, tenant: str, priority,
                 q: float) -> Optional[float]:
        d = self._digests.get((metric, str(tenant), str(priority)))
        return d.quantile(q) if d is not None else None

    def _items(self) -> List[Tuple[Tuple[str, str, str], QuantileDigest]]:
        """Stable snapshot of the key map — observe() may be inserting
        a first-seen key from the engine thread while a scrape walks
        it, and dict iteration would raise RuntimeError."""
        with self._lock:
            return sorted(self._digests.items())

    def keys(self) -> List[Tuple[str, str, str]]:
        return [k for k, _ in self._items()]

    def items(self) -> List[Tuple[Tuple[str, str, str], QuantileDigest]]:
        """Public stable snapshot of ((metric, tenant, priority),
        digest) pairs — the merge/alerting surface."""
        return self._items()

    @property
    def capacity(self) -> int:
        return self._capacity

    def clear(self) -> None:
        with self._lock:
            self._digests.clear()

    def snapshot(self) -> dict:
        """{metric: [{tenant, priority, count, p50, p90, p99}, ...]}"""
        out: Dict[str, list] = {}
        for (metric, tenant, prio), d in self._items():
            row = {"tenant": tenant, "priority": prio, "count": len(d)}
            for qname, v in zip([n for _, n in SLO_QUANTILES],
                                d.quantiles([q for q, _ in SLO_QUANTILES])):
                row[qname] = v
            out.setdefault(metric, []).append(row)
        return out

    def publish(self, registry: Optional[Registry] = None) -> None:
        """Render every digest's quantiles into gauges on ``registry``
        (families created idempotently there). One window sort per
        digest per scrape — never per quantile."""
        r = registry or default_registry()
        counts = r.gauge("pd_slo_samples",
                         "observations currently in the SLO digest "
                         "window",
                         labelnames=("metric", "tenant", "priority"))
        for (metric, tenant, prio), d in self._items():
            name, help_ = _SLO_FAMILIES.get(metric, (f"pd_slo_{metric}",
                                                     "SLO digest"))
            fam = r.gauge(name, help_,
                          labelnames=("tenant", "priority", "quantile"))
            for (q, qname), v in zip(
                    SLO_QUANTILES,
                    d.quantiles([q for q, _ in SLO_QUANTILES])):
                if v is not None:
                    fam.labels(tenant=tenant, priority=prio,
                               quantile=qname).set(v)
            counts.labels(metric=metric, tenant=tenant,
                          priority=prio).set(len(d))


_default_slo = SLODigest(
    enabled=os.environ.get("PD_OBS_DISABLED", "0") != "1")


def default_slo_digest() -> SLODigest:
    return _default_slo


def set_default_slo_digest(digest: SLODigest) -> SLODigest:
    """Swap the process default (tests/benches); returns the previous
    one. The scheduler binds the digest at construction — swap BEFORE
    building the engine whose observations you want isolated."""
    global _default_slo
    prev, _default_slo = _default_slo, digest
    return prev


def _slo_collect_hook(registry: Registry) -> None:
    # publish ONLY into the default registry: collect hooks run for
    # every exported registry, and a fabric registry view (its own
    # Registry merging per-replica state) must not be polluted with the
    # process-default digest's samples on scrape
    if registry is not default_registry():
        return
    _default_slo.publish(registry)


register_collect_hook(_slo_collect_hook)

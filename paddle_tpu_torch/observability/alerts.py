"""SLO burn-rate alerting over the fabric's exact digest windows.

Counterpart of ``paddle_tpu/observability/alerts.py`` (host Python).

The SRE-standard guardrail: instead of paging on a raw p99, page on how
fast the ERROR BUDGET burns — the fraction of requests violating the
objective divided by the allowed fraction — and only when BOTH a fast
and a slow window agree (the fast window catches a fresh regression
quickly; the slow window keeps a transient blip from paging). Windows
here are step-time equivalents: the digests observe per-request
latencies, so "1 min" and "10 min" become the newest ``fast_window``
and ``slow_window`` samples of each replica's exact
:class:`~.stepprof.SLODigest` window (no bucket interpolation — the
same raw samples the percentile readout uses).

Objectives come from the serving policy (``policy.SLO_TTFT_MS`` /
``policy.SLO_ITL_MS``, env ``PD_SLO_TTFT_MS`` / ``PD_SLO_ITL_MS``), per
(tenant, priority) series. Both default to 0 =
alerting off: evaluation is skipped entirely, the pre-bound
``pd_slo_burn_rate`` gauges stay at 0, no recorder events are emitted,
and routing/brownout behavior is bit-identical to a build without this
module — a deployment must opt in before observation can steer action.

When enabled, the loop closes two ways:

- **router steering** — a replica whose OWN windows burn above
  threshold lands in :attr:`SLOAlerts.burning`; the fabric's ``_route``
  drops burning replicas from the candidate set while at least one
  healthy candidate remains.
- **brownout input** — each burning replica's
  ``BrownoutController.alert_pressure`` is raised, which counts as
  pressure (and vetoes calm) in the ladder evaluation, so sustained
  burn climbs the degradation ladder even while queue/page fractions
  look healthy.

Alert state machines are per (tenant, priority) with up/down hysteresis
(``up_after`` consecutive burning evaluations fire; ``down_after``
consecutive healthy ones clear), and a ``min_samples`` floor keeps an
idle fabric from ever firing. Transitions emit ``alert`` recorder
events ("fire"/"clear"); every evaluation refreshes the
``pd_slo_burn_rate{tenant,priority,window}`` gauges.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Set, Tuple

from .metrics import Registry, default_registry
from .recorder import default_recorder

__all__ = ["AlertConfig", "SLOAlerts"]

# the two burn windows every gauge/evaluation reports
BURN_WINDOWS = ("fast", "slow")


def _env_ms(name: str, default: int) -> int:
    try:
        return max(int(os.environ.get(name, default)), 0)
    except ValueError:
        return default


def _policy_objectives() -> Tuple[int, int]:
    """(ttft_ms, itl_ms) from the serving policy, read LAZILY so env
    overrides set after process start are honored at fabric
    construction, and so importing this module never drags the serving
    stack in."""
    from ..inference.llm import policy
    return (_env_ms("PD_SLO_TTFT_MS", policy.SLO_TTFT_MS),
            _env_ms("PD_SLO_ITL_MS", policy.SLO_ITL_MS))


@dataclasses.dataclass(frozen=True)
class AlertConfig:
    """Burn-rate thresholds, windows and hysteresis. ``ttft_ms`` /
    ``itl_ms`` default to None = the policy knobs (0 disables that
    objective; both 0 disables the evaluator)."""

    ttft_ms: Optional[int] = None   # TTFT objective; None = policy knob
    itl_ms: Optional[int] = None    # inter-token objective; None = policy
    budget: float = 0.01            # allowed violating fraction (1%)
    threshold: float = 1.0          # burn >= this on BOTH windows -> hot
    fast_window: int = 32           # newest samples per replica ("1 min")
    slow_window: int = 256          # newest samples per replica ("10 min")
    eval_every: int = 8             # fabric steps between evaluations
    up_after: int = 2               # hot evals before firing
    down_after: int = 4             # healthy evals before clearing
    min_samples: int = 8            # idle fabric must never fire

    def __post_init__(self):
        if not 0.0 < self.budget <= 1.0:
            raise ValueError("budget must be in (0, 1]")
        if self.fast_window < 1 or self.slow_window < self.fast_window:
            raise ValueError("need slow_window >= fast_window >= 1")


class SLOAlerts:
    """Multi-window burn-rate evaluator for one :class:`ServingFabric`.

    The fabric constructs one and calls :meth:`tick` once per fabric
    step; every ``eval_every``-th tick runs :meth:`evaluate`. Inert
    (one branch per tick) when no objective is configured."""

    def __init__(self, fabric, config: Optional[AlertConfig] = None,
                 registry: Optional[Registry] = None):
        self._fabric = fabric
        cfg = config or AlertConfig()
        p_ttft, p_itl = (_policy_objectives()
                         if cfg.ttft_ms is None or cfg.itl_ms is None
                         else (0, 0))
        ttft_ms = cfg.ttft_ms if cfg.ttft_ms is not None else p_ttft
        itl_ms = cfg.itl_ms if cfg.itl_ms is not None else p_itl
        self.config = cfg
        # objective map in SECONDS, only the configured metrics
        self.objectives: Dict[str, float] = {}
        if ttft_ms > 0:
            self.objectives["ttft"] = ttft_ms / 1000.0
        if itl_ms > 0:
            self.objectives["itl"] = itl_ms / 1000.0
        self.enabled = bool(self.objectives)
        self._rec = default_recorder()
        reg = registry or default_registry()
        self._gauge = reg.gauge(
            "pd_slo_burn_rate",
            "error-budget burn rate (violating fraction / budget) per "
            "(tenant, priority) over the fast and slow step-time "
            "windows; >= 1 on both windows sustained = alert",
            labelnames=("tenant", "priority", "window"))
        # pre-bind the default series at 0 so the family exports
        # before (or without) any evaluation running
        for w in BURN_WINDOWS:
            self._gauge.labels(tenant="default", priority="0",
                               window=w).set(0.0)
        self._step_i = 0
        self.evaluations = 0
        self._hot: Dict[Tuple[str, str], int] = {}
        self._cool: Dict[Tuple[str, str], int] = {}
        self._firing: Dict[Tuple[str, str], dict] = {}
        self._burns: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self.burning: Set[int] = set()
        self.fires = 0
        self.clears = 0

    # ------------------------------------------------------------ math --
    @staticmethod
    def _burn(tails: List[List[float]], objective: float, n: int,
              budget: float) -> Tuple[float, int]:
        """(burn rate, samples) over the newest ``n`` samples of each
        replica's arrival-ordered window, pooled."""
        viol = total = 0
        for w in tails:
            tail = w[-n:]
            total += len(tail)
            viol += sum(1 for v in tail if v > objective)
        if total == 0:
            return 0.0, 0
        return (viol / total) / budget, total

    def _windows(self, metric: str) -> Dict[Tuple[str, str],
                                            List[List[float]]]:
        """{(tenant, priority): [per-replica arrival-ordered windows]}
        for one metric, replica-indexed (index aligned with
        ``fabric.replicas``)."""
        out: Dict[Tuple[str, str], List[List[float]]] = {}
        n = len(self._fabric.replicas)
        for i, eng in enumerate(self._fabric.replicas):
            for (m, tenant, prio), qd in eng.scheduler.slo_digest.items():
                if m != metric:
                    continue
                rows = out.setdefault((tenant, prio), [[] for _ in range(n)])
                rows[i] = qd.values()
        return out

    # ------------------------------------------------------------ loop --
    def tick(self) -> None:
        """Once per fabric step; evaluates every ``eval_every``-th."""
        if not self.enabled:
            return
        self._step_i += 1
        if self._step_i % self.config.eval_every == 0:
            self.evaluate()

    def evaluate(self) -> None:
        """One evaluation pass: recompute fabric burn per (tenant,
        priority), advance the hysteresis state machines, refresh the
        gauges, recompute burning replicas and feed the brownout
        controllers."""
        if not self.enabled:
            return
        self.evaluations += 1
        c = self.config
        # (tenant, prio) -> worst (fast, slow, samples, binding metric)
        fabric_burn: Dict[Tuple[str, str], tuple] = {}
        replica_hot: Set[int] = set()
        for metric, objective in sorted(self.objectives.items()):
            for key, rows in self._windows(metric).items():
                fast, _ = self._burn(rows, objective, c.fast_window,
                                     c.budget)
                slow, samples = self._burn(rows, objective, c.slow_window,
                                           c.budget)
                cur = fabric_burn.get(key)
                if cur is None or min(fast, slow) > min(cur[0], cur[1]):
                    fabric_burn[key] = (fast, slow, samples, metric)
                # per-replica steering signal: a replica burns when its
                # OWN windows exceed threshold with enough samples
                for i, w in enumerate(rows):
                    if len(w) < c.min_samples:
                        continue
                    rf, _ = self._burn([w], objective, c.fast_window,
                                       c.budget)
                    rs, _ = self._burn([w], objective, c.slow_window,
                                       c.budget)
                    if rf >= c.threshold and rs >= c.threshold:
                        replica_hot.add(i)
        self._burns = {k: (v[0], v[1]) for k, v in fabric_burn.items()}
        for (tenant, prio), (fast, slow, samples, metric) \
                in sorted(fabric_burn.items()):
            self._gauge.labels(tenant=tenant, priority=prio,
                               window="fast").set(fast)
            self._gauge.labels(tenant=tenant, priority=prio,
                               window="slow").set(slow)
            key = (tenant, prio)
            hot = (samples >= c.min_samples and fast >= c.threshold
                   and slow >= c.threshold)
            if hot:
                self._cool[key] = 0
                self._hot[key] = self._hot.get(key, 0) + 1
                if key not in self._firing \
                        and self._hot[key] >= c.up_after:
                    self._firing[key] = {
                        "tenant": tenant, "priority": prio,
                        "metric": metric, "burn_fast": fast,
                        "burn_slow": slow}
                    self.fires += 1
                    self._rec.emit("alert", "fire", tenant=tenant,
                                   priority=prio, metric=metric,
                                   burn_fast=round(fast, 3),
                                   burn_slow=round(slow, 3))
            else:
                self._hot[key] = 0
                self._cool[key] = self._cool.get(key, 0) + 1
                if key in self._firing \
                        and self._cool[key] >= c.down_after:
                    self._firing.pop(key)
                    self.clears += 1
                    self._rec.emit("alert", "clear", tenant=tenant,
                                   priority=prio, metric=metric,
                                   burn_fast=round(fast, 3),
                                   burn_slow=round(slow, 3))
        # steer only while something is actually FIRING — transient
        # sub-hysteresis burn must not flap routing
        self.burning = replica_hot if self._firing else set()
        for i, eng in enumerate(self._fabric.replicas):
            eng.brownout.alert_pressure = i in self.burning

    # ----------------------------------------------------------- query --
    def active(self) -> List[dict]:
        """Currently firing alerts, stable order."""
        return [dict(v) for _, v in sorted(self._firing.items())]

    def burn_rates(self) -> Dict[Tuple[str, str], Tuple[float, float]]:
        """{(tenant, priority): (fast, slow)} from the last
        evaluation."""
        return dict(self._burns)

    def publish(self, registry: Registry) -> None:
        """Mirror the last evaluation's burn gauges (and the pre-bound
        zero series) into ``registry`` — what the fabric metrics view
        calls at scrape."""
        fam = registry.gauge(
            "pd_slo_burn_rate", self._gauge.help,
            labelnames=("tenant", "priority", "window"))
        for lv, child in self._gauge.samples():
            fam.labels(*lv).set(child.value)

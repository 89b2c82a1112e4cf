"""Overload brownout controller: graceful degradation under pressure.

Counterpart of ``paddle_tpu/inference/llm/brownout.py``: the same
ladder, thresholds, hysteresis and retry-after hint, so a scripted
pressure sequence walks both controllers through the same levels.

A serving engine under sustained overload has exactly two honest
choices: degrade deliberately, or degrade by accident (queues growing
without bound, deadlines blowing, the watchdog firing). This module is
the deliberate version — a feedback loop over the signals the
observability substrate makes measurable (queue/page gauges, the
per-{tenant, priority} SLO digests)
that walks a deterministic DEGRADATION LADDER when pressure is
sustained and walks back hysteretically when it clears:

    level  action (cumulative — level N applies 1..N)
    -----  ------------------------------------------------------------
      1    shrink the mixed-step ragged-token budget (halved per level:
           long prefill chunks stop crowding out decode rows)
      2    suspend speculative drafting (verify rows cost draft tokens
           the step can spend on real work; speculation is lossless,
           so outputs never change)
      3    pause prefix-cache admission (hits still served; no new
           registrations — churn + LRU bookkeeping shed under memory
           pressure)
      4    SHED: retire lowest-priority QUEUED requests with
           ``finish_reason="shed"`` and reject new lowest-priority
           submits with a typed :class:`~.scheduler.Overloaded` — both
           carrying a computed retry-after hint

Pressure is evaluated every ``eval_every`` engine steps from three
sources: queue depth as a fraction of ``max_queue``, pages in use as a
fraction of the pool, and (optionally) the queue-wait p99 from the SLO
digest against a target. ``up_after`` consecutive pressured evaluations
climb one level; ``down_after`` consecutive CALM evaluations descend
one — the asymmetry is the hysteresis that keeps the ladder from
flapping at a threshold. Every transition emits a ``brownout`` recorder
event and moves the ``pd_brownout_level`` gauge; sheds count into
``pd_shed_total{priority}``.

The retry-after hint is computed, not guessed: the queue-wait p50 the
digest is currently observing (what admission actually costs right
now), floored at ``min_retry_after_s`` and scaled up by how far above
the shed threshold the queue sits — a deeper queue tells clients to
stay away longer.

Off by default (``policy.BROWNOUT_LEVELS`` = 0;
``SchedulerConfig.brownout_levels`` turns it on). Disabled cost: one
attribute load + one branch per engine step, the observability
substrate's contract. ``alert_pressure`` (the SLO burn-rate alerts'
input) stays False until the alerts are ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ...observability import serving_metrics
from ...observability.recorder import default_recorder

__all__ = ["BrownoutConfig", "BrownoutController"]


@dataclasses.dataclass(frozen=True)
class BrownoutConfig:
    """Thresholds and hysteresis of the degradation ladder."""

    levels: int = 4                # ladder depth (0 = controller off)
    eval_every: int = 8            # engine steps between evaluations
    queue_high: float = 0.75       # waiting/max_queue: pressured at/above
    queue_low: float = 0.25        # ... calm at/below
    page_high: float = 0.95        # pages_in_use/pool: pressured at/above
    page_low: float = 0.80         # ... calm at/below
    queue_wait_high_s: float = 0.0  # SLO-digest queue-wait p99 bound (0=off)
    up_after: int = 2              # pressured evals before climbing a level
    down_after: int = 6            # calm evals before descending (hysteresis)
    shed_per_eval: int = 8         # max queued requests shed per shedding
                                   # pass (one pass per TICK at level 4 —
                                   # arrivals between evaluations must
                                   # not regrow the queue unboundedly)
    min_retry_after_s: float = 0.05
    retry_horizon_s: float = 1.0   # retry-after scale at 100% queue depth


class BrownoutController:
    """Per-engine feedback loop. The engine calls :meth:`tick` once per
    step (before planning, so a shed happens before the admission
    scan); everything else is internal. ``level`` is the current ladder
    position; 0 means every degradation is reversed."""

    def __init__(self, engine, config: Optional[BrownoutConfig] = None):
        sch = engine.scheduler
        levels = sch.config.brownout_levels
        self.config = config or BrownoutConfig(
            levels=levels if levels > 0 else BrownoutConfig.levels)
        # the scheduler and the cache, never the engine: the engine
        # holds this controller, and a cycle would keep a dropped
        # engine's pools on the card until a collection
        self._sch = sch
        self._cache = engine.cache
        self.enabled = levels > 0 if config is None else \
            self.config.levels > 0
        self.level = 0
        self._hot = 0          # consecutive pressured evaluations
        self._cool = 0         # consecutive calm evaluations
        self._step_i = 0
        self.transitions = 0
        self.sheds = 0
        # SLO burn-rate alert input: a firing alert counts as pressure
        # and blocks calm. The alerts are not ported; nothing sets it
        self.alert_pressure = False
        # the base the level-1+ budget shrink halves from: the config
        # budget when one is set, else the most tokens a step can pack
        cfg = sch.config
        self._budget_base = (cfg.step_token_budget if cfg.step_token_budget
                             else cfg.max_step_tokens())
        m = serving_metrics()
        self._gauge = m["brownout_level"]
        self._gauge.set(0)
        self._rec = default_recorder()
        # the SLO digest: the scheduler observes queue_wait into it;
        # the controller reads percentiles back out
        self._slo = sch._slo

    # ----------------------------------------------------------- signals --
    def _queue_frac(self) -> float:
        return self._sch.num_waiting / max(self._sch.config.max_queue, 1)

    def _page_frac(self) -> float:
        c = self._cache.config
        return self._cache.pages_in_use / max(c.num_pages - 1, 1)

    def _queue_wait_p(self, q: float) -> float:
        """Worst queue-wait quantile across every {tenant, priority}
        digest (0.0 when nothing has been observed yet)."""
        worst = 0.0
        for key in self._slo.keys():
            if key[0] != "queue_wait":
                continue
            v = self._slo.quantile("queue_wait", key[1], key[2], q)
            if v is not None and v > worst:
                worst = v
        return worst

    def retry_after_s(self) -> float:
        """The backoff hint attached to every shed/Overloaded
        rejection: what admission currently costs (queue-wait p50)
        plus a queue-depth-proportional term, floored at
        ``min_retry_after_s`` — always > 0."""
        c = self.config
        return max(c.min_retry_after_s,
                   self._queue_wait_p(0.5),
                   self._queue_frac() * c.retry_horizon_s)

    # ------------------------------------------------------------- loop --
    def tick(self) -> int:
        """Called once per engine step; evaluates every
        ``eval_every``-th call. Returns the current level."""
        if not self.enabled:
            return 0
        self._step_i += 1
        if self._step_i % self.config.eval_every == 0:
            self._evaluate()
        if self.level >= 4:
            # keep shedding while saturated: new arrivals between
            # evaluations must not regrow the queue unboundedly
            self._shed()
        return self.level

    def _evaluate(self) -> None:
        c = self.config
        qf, pf = self._queue_frac(), self._page_frac()
        qw = (self._queue_wait_p(0.99) if c.queue_wait_high_s > 0 else 0.0)
        pressured = (qf >= c.queue_high or pf >= c.page_high
                     or (c.queue_wait_high_s > 0
                         and qw >= c.queue_wait_high_s)
                     or self.alert_pressure)
        calm = (qf <= c.queue_low and pf <= c.page_low
                and (c.queue_wait_high_s <= 0
                     or qw < c.queue_wait_high_s)
                and not self.alert_pressure)
        if pressured:
            self._cool = 0
            self._hot += 1
            if self._hot >= c.up_after and self.level < c.levels:
                self._transition(self.level + 1, qf, pf)
                self._hot = 0
        elif calm:
            self._hot = 0
            self._cool += 1
            if self._cool >= c.down_after and self.level > 0:
                self._transition(self.level - 1, qf, pf)
                self._cool = 0
        else:               # middle band: hold the level, reset streaks
            self._hot = 0
            self._cool = 0

    def _transition(self, new_level: int, qf: float, pf: float) -> None:
        old, self.level = self.level, new_level
        self.transitions += 1
        self._apply()
        self._gauge.set(new_level)
        self._rec.emit("engine", "brownout", level=new_level, prev=old,
                       direction="up" if new_level > old else "down",
                       queue_frac=round(qf, 4), page_frac=round(pf, 4))

    def _apply(self) -> None:
        """Make scheduler/cache state match ``self.level`` (cumulative
        actions; descending reverses them in the same order)."""
        sch, lvl = self._sch, self.level
        if lvl >= 1:
            sch.step_budget_override = max(
                self._sch.config.min_bucket, self._budget_base >> lvl)
        else:
            sch.step_budget_override = None
        sch.spec_suspended = lvl >= 2
        self._cache.prefix_admission_paused = lvl >= 3
        if lvl >= 4:
            sch.overload_retry_after_s = self.retry_after_s()
            # reject new submits only in the LOWEST class; with a
            # single class there is no lower-value work to distinguish,
            # so submit-side shedding stays off (queue-full still
            # backpressures)
            classes = sch.config.priority_classes
            sch.shed_floor = classes - 1 if classes > 1 else None
        else:
            sch.shed_floor = None
            sch.overload_retry_after_s = 0.0

    def _shed(self) -> None:
        retry = self.retry_after_s()
        self._sch.overload_retry_after_s = retry
        if self._sch.config.priority_classes > 1:
            self.sheds += self._sch.shed_queued(
                self.config.shed_per_eval, retry)

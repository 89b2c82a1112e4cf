"""Fault injection + chaos harness for the serving stack.

Counterpart of ``paddle_tpu/inference/llm/faults.py``: the same config,
the same seeded draws in the same order (a ``FaultInjector`` of the
same config and seed, consulted in the same order, gives the JAX one's
answers), and the same chaos harness.

- :class:`FaultInjector` — a deterministic (seeded) injection layer the
  scheduler and engine consult on their hot paths. All rates default to
  0 and the disabled check is one attribute load + one branch.
  Injectable faults:

  * **allocator exhaustion** (``alloc_fail_rate``): an admission scan
    behaves as if the page pool could not reserve the candidate's
    footprint.
  * **delayed steps** (``delay_rate`` x ``delay_ms``): the engine
    sleeps before a step.
  * **mid-request cancels** (``cancel_rate``) and **malformed submits**
    (``malformed_rate``): applied by the chaos harness, not the engine.
  * **process kill** (``kill_step``): the engine raises
    :class:`EngineKilled` at the top of step N, for the journal's
    restore tests.
  * **NaN'd logits** (``nan_rate``) and **dispatch exceptions**
    (``dispatch_rate``): drive the engine's device-fault boundary — a
    poisoned row or a failed dispatch is retried once on the engine's
    own route (at depth > 0 the retry is recorded and the rows
    quarantined at once) and then only the offending rows' requests
    terminate ``device_fault``; the engine itself never dies. A real
    exception from a step is not retried: it propagates.
  * **replica kills** (``replica_kill``, ``replica_kill_step``): the
    serving fabric consults :meth:`FaultInjector.should_kill_replica`
    once per fabric step and kills that replica, replaying its live
    requests onto a survivor.
  * **mesh device death** (``device_dead``, ``device_dead_step``) and
    **collective probe failures** (``collective_rate``): their fields
    are kept so a config reads as on the JAX side; one card has no mesh
    to lose them in, so :meth:`FaultInjector.dead_device` answers None
    there and nothing consults the collective rate.

- :func:`run_chaos` — the chaos test harness: a mixed-priority,
  mixed-tenant workload (some requests carrying tight deadlines)
  submitted while stepping the engine under injection, with random
  cancels and malformed submits woven in. Returns a report the caller
  asserts on.

Environment configuration (read by ``FaultConfig.from_env``, the
default-injector source): ``PD_FAULT_ALLOC_FAIL``, ``PD_FAULT_DELAY_RATE``,
``PD_FAULT_DELAY_MS``, ``PD_FAULT_CANCEL_RATE``,
``PD_FAULT_MALFORMED_RATE``, ``PD_FAULT_NAN_RATE``,
``PD_FAULT_DISPATCH_RATE``, ``PD_FAULT_COLLECTIVE_RATE`` (all rates in
[0, 1]), ``PD_FAULT_KILL_STEP`` (step index, 0 = off),
``PD_FAULT_DEVICE_DEAD`` + ``PD_FAULT_DEVICE_DEAD_STEP``,
``PD_FAULT_REPLICA_KILL`` + ``PD_FAULT_REPLICA_KILL_STEP``,
``PD_FAULT_SEED``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["FaultConfig", "FaultInjector", "EngineKilled", "DeviceLost",
           "default_injector", "set_default_injector", "run_chaos"]


class EngineKilled(RuntimeError):
    """Injected process death (``PD_FAULT_KILL_STEP``): raised at the
    top of the doomed engine step, BEFORE any of its work — exactly the
    state an OOM-kill or power loss would leave on disk. The recovery
    tests catch it, abandon the engine, and ``restore()`` a fresh one
    from the journal."""


class DeviceLost(RuntimeError):
    """A mesh device stopped answering — injected
    (``PD_FAULT_DEVICE_DEAD``) or classified from a real runtime
    error. Carries the backend device index when known (``None`` =
    unattributed, e.g. repeated collective-probe failures); the mesh
    recovery controller consumes it to exclude the corpse from the
    rebuilt mesh."""

    def __init__(self, msg: str, device: Optional[int] = None):
        super().__init__(msg)
        self.device = device


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    alloc_fail_rate: float = 0.0     # admission scans that see a "full" pool
    delay_rate: float = 0.0          # engine steps delayed
    delay_ms: float = 0.0            # length of one injected delay
    cancel_rate: float = 0.0         # harness: cancel a live request / step
    malformed_rate: float = 0.0      # harness: malformed submit probability
    seed: int = 1337
    # device-fault / crash injection (appended fields — the positional
    # prefix above is a recorded API)
    kill_step: int = 0               # raise EngineKilled at step N (0 = off)
    nan_rate: float = 0.0            # rows whose sampled logits read NaN
    dispatch_rate: float = 0.0       # step dispatches that raise
    # mesh-fault injection (appended fields): kill one mesh device at
    # the device_dead_step-th dispatch consult (-1 = off); fail mesh
    # liveness probes at a seeded rate
    device_dead: int = -1            # backend device index to kill
    device_dead_step: int = 1        # dispatch consult the death lands on
    collective_rate: float = 0.0     # liveness probes that fail
    # serving-fabric fault injection (appended fields): kill one engine
    # replica at the replica_kill_step-th fabric step consult (-1 =
    # off) — the fabric replays the victim's live requests onto a
    # survivor and respawns the slot
    replica_kill: int = -1           # fabric replica index to kill
    replica_kill_step: int = 1       # fabric step the kill lands on

    @classmethod
    def from_env(cls) -> "FaultConfig":
        return cls(
            alloc_fail_rate=_env_float("PD_FAULT_ALLOC_FAIL", 0.0),
            delay_rate=_env_float("PD_FAULT_DELAY_RATE", 0.0),
            delay_ms=_env_float("PD_FAULT_DELAY_MS", 0.0),
            cancel_rate=_env_float("PD_FAULT_CANCEL_RATE", 0.0),
            malformed_rate=_env_float("PD_FAULT_MALFORMED_RATE", 0.0),
            seed=int(_env_float("PD_FAULT_SEED", 1337)),
            kill_step=int(_env_float("PD_FAULT_KILL_STEP", 0)),
            nan_rate=_env_float("PD_FAULT_NAN_RATE", 0.0),
            dispatch_rate=_env_float("PD_FAULT_DISPATCH_RATE", 0.0),
            device_dead=int(_env_float("PD_FAULT_DEVICE_DEAD", -1)),
            device_dead_step=int(_env_float("PD_FAULT_DEVICE_DEAD_STEP",
                                            1)),
            collective_rate=_env_float("PD_FAULT_COLLECTIVE_RATE", 0.0),
            replica_kill=int(_env_float("PD_FAULT_REPLICA_KILL", -1)),
            replica_kill_step=int(_env_float("PD_FAULT_REPLICA_KILL_STEP",
                                             1)))


class FaultInjector:
    """Seeded probabilistic fault source. One injector may be shared by
    a scheduler, an engine and a chaos harness — the roll sequence is
    then a deterministic function of (seed, call order), so a chaos run
    with a fixed workload replays exactly."""

    def __init__(self, config: Optional[FaultConfig] = None):
        self.config = config or FaultConfig.from_env()
        self._rng = np.random.default_rng(self.config.seed)
        self.counts: Dict[str, int] = {}

    @property
    def active(self) -> bool:
        c = self.config
        return (c.alloc_fail_rate > 0 or c.delay_rate > 0
                or c.cancel_rate > 0 or c.malformed_rate > 0
                or c.kill_step > 0 or c.nan_rate > 0
                or c.dispatch_rate > 0 or c.device_dead >= 0
                or c.collective_rate > 0 or c.replica_kill >= 0)

    def _roll(self, rate: float, kind: str) -> bool:
        if rate <= 0.0:
            return False
        if self._rng.random() >= rate:
            return False
        self.counts[kind] = self.counts.get(kind, 0) + 1
        return True

    # ---- engine/scheduler-consulted faults -----------------------------
    def alloc_fail(self) -> bool:
        """One admission scan sees the pool as unable to allocate."""
        return self._roll(self.config.alloc_fail_rate, "alloc_fail")

    def step_delay_s(self) -> float:
        """Seconds the engine should sleep before this step (0 = none)."""
        if self._roll(self.config.delay_rate, "delay"):
            return self.config.delay_ms / 1000.0
        return 0.0

    def should_kill(self) -> bool:
        """True exactly once, at the ``kill_step``-th consultation —
        the engine raises :class:`EngineKilled` before doing that
        step's work. Counted from 1; 0 disables."""
        if self.config.kill_step <= 0:
            return False
        n = self.counts.get("kill_probe", 0) + 1
        self.counts["kill_probe"] = n
        if n == self.config.kill_step:
            self.counts["kill"] = self.counts.get("kill", 0) + 1
            return True
        return False

    def nan_row(self, rid: Optional[int] = None) -> bool:
        """This step row's sampled logits should read as NaN-poisoned
        (the quarantine path treats it exactly like a real non-finite
        logits scan hit). ``rid`` identifies the row's request so
        targeted subclasses can poison one victim deterministically;
        the stock roll ignores it."""
        return self._roll(self.config.nan_rate, "nan")

    def dispatch_fault(self) -> bool:
        """This step's unified dispatch should raise (retried once by
        the engine's fault boundary)."""
        return self._roll(self.config.dispatch_rate, "dispatch")

    def dead_device(self, active_devices: Sequence[int]) -> Optional[int]:
        """The injected dead device's index when the death has landed
        AND the current mesh still spans it, else None. Each consult
        advances the shared dispatch clock; from consult
        ``device_dead_step`` on, every dispatch touching the device
        reports it dead. One card is no mesh: None, and the clock does
        not move."""
        c = self.config
        active = tuple(active_devices)
        if (c.device_dead < 0 or len(active) <= 1
                or c.device_dead not in active):
            return None
        n = self.counts.get("device_dead_clock", 0) + 1
        self.counts["device_dead_clock"] = n
        if n >= max(c.device_dead_step, 1):
            self.counts["device_dead"] = \
                self.counts.get("device_dead", 0) + 1
            return c.device_dead
        return None

    def should_kill_replica(self) -> bool:
        """True exactly once, at the ``replica_kill_step``-th
        consultation (the fabric consults once per fabric step): the
        fabric kills replica ``replica_kill``, replays its live requests
        onto a survivor and respawns the slot. Counted from 1;
        ``replica_kill < 0`` disables."""
        if self.config.replica_kill < 0:
            return False
        n = self.counts.get("replica_kill_probe", 0) + 1
        self.counts["replica_kill_probe"] = n
        if n == max(self.config.replica_kill_step, 1):
            self.counts["replica_kill"] = \
                self.counts.get("replica_kill", 0) + 1
            return True
        return False

    # ---- harness-consulted faults ---------------------------------------
    def should_cancel(self) -> bool:
        return self._roll(self.config.cancel_rate, "cancel")

    def should_malform(self) -> bool:
        return self._roll(self.config.malformed_rate, "malformed")

    def choice(self, seq: Sequence):
        return seq[int(self._rng.integers(0, len(seq)))]

    def reset(self) -> None:
        self._rng = np.random.default_rng(self.config.seed)
        self.counts.clear()


_default = FaultInjector()


def default_injector() -> FaultInjector:
    return _default


def set_default_injector(inj: FaultInjector) -> FaultInjector:
    """Swap the process default (tests/benches); returns the previous
    one. Components bind the injector at construction, so swap BEFORE
    building the engine you want to torment."""
    global _default
    prev, _default = _default, inj
    return prev


# --------------------------------------------------------------------------
# chaos harness
# --------------------------------------------------------------------------

_MALFORMED_KINDS = ("empty_prompt", "zero_tokens", "too_long",
                    "bad_priority")


def _submit_malformed(engine, kind: str, vocab: int, cfg):
    """One malformed submit of the given kind — must raise
    InvalidRequest without burning a rid or recording an event.
    ``cfg`` is the scheduler config."""
    max_seq = cfg.max_seq_len
    if kind == "empty_prompt":
        engine.submit([], 4)
    elif kind == "zero_tokens":
        engine.submit([1, 2, 3], 0)
    elif kind == "too_long":
        engine.submit(list(range(max_seq)), max_seq)
    else:   # bad_priority
        engine.submit([1, 2, 3], 4, priority=cfg.priority_classes + 7)


def run_chaos(engine, n_requests: int = 24, vocab: int = 64, seed: int = 0,
              injector: Optional[FaultInjector] = None,
              max_steps: int = 20000, watchdog=None,
              deadline_fraction: float = 0.2,
              check_every: int = 16) -> dict:
    """Drive ``engine`` through a mixed-priority, mixed-tenant workload
    under fault injection and report on the lifecycle invariants (the
    JAX harness's workload and report):

    - ``drained``: all work reached a terminal state within
      ``max_steps`` engine steps (no hang);
    - ``all_terminal`` / ``truthful_reasons``: every admitted request
      finished with a ``finish_reason`` consistent with what actually
      happened to it;
    - ``free_pages_restored``: the pool drained back to its starting
      free+evictable capacity — no page leaked;
    - ``invariants_ok``: ``PagedKVCache.check_invariants()`` passed at
      every checkpoint and at drain;
    - ``watchdog_stalls``: stall count of the (optional) watchdog.

    Accepts a :class:`~.fabric.ServingFabric` in place of ``engine``:
    the workload then drives the fabric's routed surface, random
    cancels draw from every replica's live set, the malformed-submit
    leak check covers every replica's rid counter, a
    ``replica_kill``-configured injector fires through ``fabric.step``
    (the report's ``migrated`` counts the replayed requests), and the
    leak and invariant checks run on every replica, respawned slots
    included.
    """
    from ...observability.recorder import default_recorder
    from .scheduler import InvalidRequest, QueueFull

    is_fabric = hasattr(engine, "replicas")
    schedulers = ([r.scheduler for r in engine.replicas] if is_fabric
                  else [engine.scheduler])
    cfg = schedulers[0].config
    inj = injector or getattr(engine, "_faults", None) or default_injector()
    rng = np.random.default_rng(seed)
    rec = default_recorder()
    classes = cfg.priority_classes
    tenants = ("acme", "bolt", "corp")
    max_seq = cfg.max_seq_len

    def has_work() -> bool:
        return (engine.has_work if is_fabric
                else engine.scheduler.has_work or engine.pipeline_depth)

    def next_rids() -> tuple:
        # replicas respawn mid-chaos, so re-read the scheduler list
        if is_fabric:
            return tuple(r.scheduler._next_rid for r in engine.replicas)
        return (engine.scheduler._next_rid,)

    def live_rids():
        if is_fabric:
            return engine.live_rids()
        return ([r.rid for r in engine.scheduler.waiting]
                + [r.rid for r in engine.scheduler.running.values()])

    def check_pools() -> None:
        if is_fabric:
            engine.check_invariants()
        else:
            engine.cache.check_invariants()

    admitted: Dict[int, dict] = {}
    cancelled_rids = set()
    deadline_rids = set()
    malformed_attempts = 0
    malformed_leaks = 0
    rejected = 0
    invariants_ok = True
    free0 = None if is_fabric else engine.cache.num_free_pages
    pending = n_requests
    steps = 0

    while pending > 0 or has_work():
        if steps >= max_steps:
            break
        if pending > 0 and rng.random() < 0.6:
            pending -= 1
            if inj.should_malform():
                malformed_attempts += 1
                rid_before = next_rids()
                events_before = len(rec)
                try:
                    _submit_malformed(engine,
                                      inj.choice(_MALFORMED_KINDS), vocab,
                                      cfg)
                    malformed_leaks += 1      # should have raised
                except InvalidRequest:
                    if (next_rids() != rid_before
                            or len(rec) != events_before):
                        malformed_leaks += 1  # burned a rid or an event
            else:
                plen = int(rng.integers(2, max(4, max_seq // 6)))
                prompt = rng.integers(0, vocab, size=plen).tolist()
                mnt = int(rng.integers(2, 10))
                kw = dict(priority=int(rng.integers(0, classes)),
                          tenant=str(inj.choice(tenants)))
                if rng.random() < deadline_fraction:
                    if rng.random() < 0.5:
                        kw["ttft_deadline_s"] = float(rng.uniform(.005, .05))
                    else:
                        kw["deadline_s"] = float(rng.uniform(0.01, 0.08))
                try:
                    rid = engine.submit(prompt, mnt, **kw)
                    admitted[rid] = dict(kw, max_new_tokens=mnt)
                    if "deadline_s" in kw or "ttft_deadline_s" in kw:
                        deadline_rids.add(rid)
                except QueueFull:
                    rejected += 1
        if inj.should_cancel():
            live = live_rids()
            if live:
                rid = int(inj.choice(live))
                if engine.cancel(rid):
                    cancelled_rids.add(rid)
        engine.step()
        steps += 1
        if steps % check_every == 0:
            if watchdog is not None:
                watchdog.check()
            try:
                check_pools()
            except AssertionError:
                invariants_ok = False
                break

    try:
        check_pools()
    except AssertionError:
        invariants_ok = False

    all_terminal = True
    truthful = True
    reasons: Dict[str, int] = {}
    for rid, info in admitted.items():
        if is_fabric:
            req = engine.find_request(rid)
        else:
            req = engine.scheduler.requests.get(rid)
        if req is None or req.state != "finished":
            all_terminal = False
            continue
        reason = req.finish_reason
        reasons[reason] = reasons.get(reason, 0) + 1
        if reason == "cancelled":
            # the harness cancels by CURRENT rid, but a migrated
            # request was admitted under its pre-kill rid — follow the
            # fabric's redirect chain before declaring the reason a lie
            ok = (rid in cancelled_rids
                  or (is_fabric and engine._resolve(rid)
                      in cancelled_rids))
        elif reason == "timeout":
            ok = rid in deadline_rids
        elif reason == "max_new_tokens":
            ok = len(req.output) == info["max_new_tokens"]
        elif reason == "eos":
            ok = (len(req.output) > 0
                  and req.output[-1] == engine.eos_id)
        elif reason == "preempted":
            ok = req.preemptions > 0
        elif reason == "device_fault":
            # truthful only while device faults were actually injected
            ok = (inj.config.nan_rate > 0 or inj.config.dispatch_rate > 0)
        elif reason == "shed":
            # every shed request must carry the computed backoff hint
            ok = req.retry_after_s > 0
        else:
            ok = False
        truthful = truthful and ok

    if is_fabric:
        # every replica's free list back at boot size: the fabric keeps
        # its own baseline because killed slots respawn with fresh pools
        free_restored = engine.pool_restored()
    else:
        free_restored = engine.cache.num_free_pages == free0

    def stat(key: str) -> int:
        # live schedulers only: a killed replica's counters died with
        # it, but its requests were migrated — their terminal outcomes
        # are what the truthfulness pass above already verified
        live_sch = ([r.scheduler for r in engine.replicas] if is_fabric
                    else [engine.scheduler])
        return sum(s.stats[key] for s in live_sch)

    return {
        "steps": steps,
        "submitted": len(admitted),
        "rejected_queue_full": rejected,
        "malformed_attempts": malformed_attempts,
        "malformed_leaks": malformed_leaks,
        "injected": dict(inj.counts),
        "drained": pending == 0 and not has_work(),
        "all_terminal": all_terminal,
        "truthful_reasons": truthful,
        "reasons": reasons,
        "cancelled": len(cancelled_rids),
        "preemptions": stat("n_preemptions"),
        "resumed": stat("n_resumed"),
        "timeouts": stat("n_timeouts"),
        "device_faults": stat("n_device_faults"),
        "shed": stat("n_shed"),
        "migrated": int(getattr(engine, "migrations", 0)),
        "free_pages_restored": free_restored,
        "invariants_ok": invariants_ok,
        "watchdog_stalls": (watchdog.status()["stalls_total"]
                            if watchdog is not None else 0),
    }

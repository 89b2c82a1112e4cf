"""Crash-safe request journal: hot restart without losing a request.

Counterpart of ``paddle_tpu/inference/llm/journal.py``, byte-compatible:
each package reads the other's files, and a journal the JAX engine
wrote restores in the port to the JAX run's outputs.

A serving process dies — OOM-killed, node preempted, deploy rollover —
and today every in-flight request dies with it. This module makes the
engine's request state durable enough to survive: an APPEND-ONLY,
CRC-framed journal of everything needed to finish a request after a
restart, and a ``restore`` path (``GenerationEngine.restore``) that
replays it into a fresh engine **bit-exactly**.

Why replay can be exact at all: the engine samples token ``i`` of a
request with ``fold_in(PRNGKey(seed), i)`` — a pure function of the
request's (journaled) seed and the token stream, independent of
batching, chunking or scheduling. So a restored request that re-prefills
``prompt + journaled_output`` and keeps decoding produces the SAME
continuation the uninterrupted run would have (the preemption-resume
machinery this rides on is bit-exact-tested), and the prefix cache makes
the re-prefill cheap when pages survive in the same process.

Format (version ``PDJ1``)::

    file   := magic "PDJ1" , record*
    record := u32 payload_len , u32 crc32(payload) , payload
    payload:= compact JSON, one of
        {"t":"submit","rid":..,"prompt":[..],"mnt":..,"temp":..,
         "top_k":..,"top_p":..,"seed":..,"priority":..,"tenant":..,
         "ttft_deadline_s":..,"deadline_s":..}
        {"t":"tokens","rid":..,"toks":[..]}
        {"t":"finish","rid":..,"reason":".."}

The reader (:func:`scan_records` / :func:`read_journal`) stops at the
first frame that does not parse — truncated header, short payload, CRC
mismatch — and returns everything before it: a torn tail from a
mid-write crash costs at most the unsynced records, never the journal.
(And because replay is deterministic, a journal cut at ANY record
boundary still restores bit-exact outputs — the engine simply
regenerates what the lost records held.)

Durability/throughput knobs (defaults in ``policy.py``, the JAX
package's): ``sync_every`` (``policy.JOURNAL_SYNC_EVERY``) batches
``fsync`` — records are buffered and flushed+fsynced every N records,
so the per-token hot-path cost is one small buffer append.
``max_bytes`` (``policy.JOURNAL_MAX_BYTES``) bounds the file: past it,
:meth:`RequestJournal.maybe_compact` rewrites the journal down to its
LIVE (unfinished) requests via an atomic ``os.replace``.
``pd_journal_bytes`` gauges the current size.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ...observability import serving_metrics
from ...observability.recorder import default_recorder
from . import policy

__all__ = ["JOURNAL_MAGIC", "JournalEntry", "RequestJournal",
           "scan_records", "read_journal", "replay_records"]

JOURNAL_MAGIC = b"PDJ1"
_HDR = struct.Struct("<II")          # payload length, crc32(payload)


@dataclasses.dataclass
class JournalEntry:
    """One request's replayed journal state."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    priority: int = 0
    tenant: str = "default"
    ttft_deadline_s: float = 0.0
    deadline_s: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None    # None = still live


def _frame(payload: bytes) -> bytes:
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def _submit_record(e: JournalEntry) -> dict:
    """The one submit-payload shape — shared by the live writer and
    compaction so a journaled field can never exist in one and not the
    other (a compaction would silently drop it from live entries)."""
    return {"t": "submit", "rid": e.rid, "prompt": e.prompt,
            "mnt": e.max_new_tokens, "temp": e.temperature,
            "top_k": e.top_k, "top_p": e.top_p, "seed": e.seed,
            "priority": e.priority, "tenant": e.tenant,
            "ttft_deadline_s": e.ttft_deadline_s,
            "deadline_s": e.deadline_s}


def _tokens_record(rid: int, tokens) -> dict:
    return {"t": "tokens", "rid": int(rid),
            "toks": [int(t) for t in tokens]}


def _scan_bytes(data: bytes) -> Tuple[List[dict], int]:
    """(complete records, byte offset of the last complete record's
    end) — the shared walk behind the reader AND the writer's
    reopen-truncate."""
    out: List[dict] = []
    off = len(JOURNAL_MAGIC)
    if data[:off] != JOURNAL_MAGIC:
        raise ValueError("not a request journal (bad magic)")
    n = len(data)
    while off + _HDR.size <= n:
        length, crc = _HDR.unpack_from(data, off)
        start = off + _HDR.size
        end = start + length
        if end > n:                      # torn tail: header without body
            break
        payload = data[start:end]
        if zlib.crc32(payload) != crc:   # bit-rot / interleaved writer
            break
        try:
            rec = json.loads(payload)
        except ValueError:               # CRC passed but not our JSON
            break
        if not isinstance(rec, dict) or "t" not in rec:
            break
        out.append(rec)
        off = end
    return out, off


def scan_records(path: str) -> Iterator[dict]:
    """Yield every COMPLETE, CRC-clean record payload in order, then
    stop — silently — at the first torn/corrupt frame (the crash-safety
    contract: recover to the last intact record, never raise on a torn
    tail). Raises ``ValueError`` only when the file is not a journal at
    all (bad magic)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data:
        return
    try:
        records, _ = _scan_bytes(data)
    except ValueError:
        raise ValueError(f"{path}: not a request journal (bad magic)")
    yield from records


def replay_records(records) -> Dict[int, JournalEntry]:
    """Fold a record stream into per-rid :class:`JournalEntry` state
    (submits create, tokens extend, finishes seal). Records for a rid
    never submitted are dropped — a compaction boundary can orphan
    them, and an orphan can add nothing to a restore."""
    entries: Dict[int, JournalEntry] = {}
    for rec in records:
        kind = rec.get("t")
        if kind == "submit":
            entries[int(rec["rid"])] = JournalEntry(
                rid=int(rec["rid"]),
                prompt=[int(t) for t in rec["prompt"]],
                max_new_tokens=int(rec["mnt"]),
                temperature=float(rec.get("temp", 0.0)),
                top_k=int(rec.get("top_k", 0)),
                top_p=float(rec.get("top_p", 1.0)),
                seed=(None if rec.get("seed") is None
                      else int(rec["seed"])),
                priority=int(rec.get("priority", 0)),
                tenant=str(rec.get("tenant", "default")),
                ttft_deadline_s=float(rec.get("ttft_deadline_s", 0.0)),
                deadline_s=float(rec.get("deadline_s", 0.0)))
        elif kind == "tokens":
            e = entries.get(int(rec["rid"]))
            if e is not None and e.finish_reason is None:
                e.tokens.extend(int(t) for t in rec["toks"])
        elif kind == "finish":
            e = entries.get(int(rec["rid"]))
            if e is not None:
                e.finish_reason = str(rec.get("reason", ""))
    return entries


def read_journal(path: str) -> Dict[int, JournalEntry]:
    """Replay ``path`` to per-request state, recovering to the last
    complete record (see :func:`scan_records`)."""
    return replay_records(scan_records(path))


class RequestJournal:
    """Append-only journal writer (one per engine).

    Hot-path contract: ``record_*`` appends one framed record to an
    in-memory buffer; every ``sync_every`` records the buffer is
    written, flushed and ``fsync``-ed as one batch. ``flush()`` forces
    the batch out (``engine.drain()`` calls it); ``close()`` flushes
    and releases the fd. The writer mirrors live-request state so
    :meth:`maybe_compact` can rewrite the file down to unfinished
    requests without re-reading it."""

    def __init__(self, path: str,
                 sync_every: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self.path = str(path)
        self.sync_every = max(int(sync_every
                                  if sync_every is not None
                                  else policy.JOURNAL_SYNC_EVERY), 1)
        self.max_bytes = max(int(max_bytes
                                 if max_bytes is not None
                                 else policy.JOURNAL_MAX_BYTES), 4096)
        self._buf: List[bytes] = []
        self._pending = 0            # records buffered since last sync
        self._live: Dict[int, JournalEntry] = {}
        self._finished_bytes = 0     # journal bytes owned by sealed rids
        self.records_written = 0
        self.syncs = 0
        self.compactions = 0
        self._gauge = serving_metrics()["journal_bytes"]
        self._rec = default_recorder()
        fresh = not os.path.exists(self.path) \
            or os.path.getsize(self.path) == 0
        if not fresh:
            # reopening an existing journal (continuation after a
            # restore): adopt its live state so compaction stays exact,
            # and TRUNCATE any torn tail first — appending after a torn
            # frame would orphan every later record behind it
            with open(self.path, "rb") as f:
                data = f.read()
            records, valid_len = _scan_bytes(data)
            self._live = {rid: e
                          for rid, e in replay_records(records).items()
                          if e.finish_reason is None}
            if valid_len < len(data):
                with open(self.path, "r+b") as f:
                    f.truncate(valid_len)
        self._f = open(self.path, "ab")
        if fresh:
            self._f.write(JOURNAL_MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())
        self.bytes_written = self._f.tell()
        self._gauge.set(self.bytes_written)

    # ------------------------------------------------------------ write --
    def _append(self, rec: dict) -> None:
        payload = json.dumps(rec, separators=(",", ":")).encode()
        self._buf.append(_frame(payload))
        self.records_written += 1
        self._pending += 1
        if self._pending >= self.sync_every:
            self.flush()

    def record_submit(self, rid: int, prompt: Sequence[int],
                      max_new_tokens: int, sampling=None,
                      priority: int = 0, tenant: str = "default",
                      ttft_deadline_s: float = 0.0,
                      deadline_s: float = 0.0) -> None:
        """Journal an ACCEPTED submit with its RESOLVED sampling params
        — the engine calls this after the per-request seed draw, so a
        replay re-submits the concrete seed, not the None that drew
        it."""
        e = JournalEntry(
            rid=int(rid), prompt=[int(t) for t in prompt],
            max_new_tokens=int(max_new_tokens),
            temperature=float(getattr(sampling, "temperature", 0.0)),
            top_k=int(getattr(sampling, "top_k", 0)),
            top_p=float(getattr(sampling, "top_p", 1.0)),
            seed=getattr(sampling, "seed", None),
            priority=int(priority), tenant=str(tenant),
            ttft_deadline_s=float(ttft_deadline_s),
            deadline_s=float(deadline_s))
        self._live[e.rid] = e
        self._append(_submit_record(e))

    def record_tokens(self, rid: int, tokens: Sequence[int]) -> None:
        e = self._live.get(int(rid))
        if e is not None:
            e.tokens.extend(int(t) for t in tokens)
        self._append(_tokens_record(rid, tokens))

    def record_finish(self, rid: int, reason: str) -> None:
        self._live.pop(int(rid), None)
        self._append({"t": "finish", "rid": int(rid),
                      "reason": str(reason)})
        self.maybe_compact()

    # ------------------------------------------------------- durability --
    def flush(self, sync: bool = True) -> None:
        """Write the buffered batch and (by default) fsync it — the
        moment after which a kill cannot lose those records."""
        if self._buf:
            self._f.write(b"".join(self._buf))
            self._buf.clear()
        self._f.flush()
        if sync:
            os.fsync(self._f.fileno())
            self.syncs += 1
        self._pending = 0
        self.bytes_written = self._f.tell()
        self._gauge.set(self.bytes_written)

    def close(self) -> None:
        if self._f.closed:
            return
        self.flush()
        self._f.close()

    # ------------------------------------------------------- compaction --
    def live_rids(self) -> List[int]:
        return sorted(self._live)

    def replay(self) -> Dict[int, JournalEntry]:
        """The writer's in-memory view of LIVE requests (what a
        restore of this journal right now would resubmit)."""
        return {rid: dataclasses.replace(e, tokens=list(e.tokens))
                for rid, e in self._live.items()}

    def entry(self, rid: int) -> Optional[JournalEntry]:
        """One live entry, copied — the serving fabric migrates a
        single request (drain or kill of its replica) by restoring
        exactly this onto a survivor. None once the rid is sealed."""
        e = self._live.get(int(rid))
        if e is None:
            return None
        return dataclasses.replace(e, tokens=list(e.tokens))

    def maybe_compact(self) -> bool:
        """Rewrite the journal down to live requests once it outgrows
        ``max_bytes`` (atomic ``os.replace``; a crash mid-compaction
        leaves the old file intact). Keeps the journal BOUNDED: sealed
        requests' records are the only thing dropped."""
        if self.bytes_written + sum(map(len, self._buf)) < self.max_bytes:
            return False
        self.flush()
        tmp = self.path + ".compact"
        with open(tmp, "wb") as f:
            f.write(JOURNAL_MAGIC)
            for rid in sorted(self._live):
                e = self._live[rid]
                f.write(_frame(json.dumps(
                    _submit_record(e), separators=(",", ":")).encode()))
                if e.tokens:
                    f.write(_frame(json.dumps(
                        _tokens_record(e.rid, e.tokens),
                        separators=(",", ":")).encode()))
            f.flush()
            os.fsync(f.fileno())
        old = self.bytes_written
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        self.compactions += 1
        self.bytes_written = self._f.tell()
        self._gauge.set(self.bytes_written)
        self._rec.emit("engine", "journal_compacted", old_bytes=old,
                       new_bytes=self.bytes_written,
                       live=len(self._live))
        return True

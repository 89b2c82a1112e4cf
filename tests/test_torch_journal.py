"""The port's request journal (``inference/llm/journal.py``, PDJ1)
against the JAX package's, on the CPU.

- Cross-package: a journal the JAX engine wrote, killed mid-run
  (``EngineKilled`` from its fault injector), restores in the port to
  the JAX engine's uninterrupted outputs, greedy and sampled; and a
  journal the port wrote restores in the JAX engine to the port's.
- ``read_journal`` of each package gives equal entries for the other's
  file, and the writers produce byte-identical files for the same
  record sequence.
- Torn tails (a half-written frame) and CRC mismatches end the replay at
  the last intact record; a reopened journal truncates its torn tail.
- Kill-and-restore inside the port is bit-exact at async depths 0 and 1,
  and a second crash after a restore restores again; ``drain`` stops
  admission and preempts the residents back to the journal's live set.
- Compaction rewrites the file down to the live requests and still
  restores.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.inference.llm import CacheConfig as JaxCacheConfig  # noqa: E402
from paddle_tpu.inference.llm import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu.inference.llm import JaxLM  # noqa: E402
from paddle_tpu.inference.llm import SamplingParams as JaxSP  # noqa: E402
from paddle_tpu.inference.llm import (  # noqa: E402
    SchedulerConfig as JaxSchedulerConfig)
from paddle_tpu.inference.llm import faults as jfaults  # noqa: E402
from paddle_tpu.inference.llm import journal as jj  # noqa: E402
from paddle_tpu_torch.inference.llm import (  # noqa: E402
    CacheConfig, GenerationEngine, QueueFull, SamplingParams,
    SchedulerConfig, TorchLM)
from paddle_tpu_torch.inference.llm import faults as tfaults  # noqa: E402
from paddle_tpu_torch.inference.llm import journal as tj  # noqa: E402
from paddle_tpu_torch.inference.llm.model import params_from_jax  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

VOCAB = 64
SAMPLED = dict(temperature=0.9, top_k=12, top_p=0.9)


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


def _sched(depth=0):
    return dict(max_slots=3, max_seq_len=128, chunk_tokens=8,
                async_depth=depth)


def _jax(models, depth=0, journal=None, kill=0):
    prev = jfaults.set_default_injector(jfaults.FaultInjector(
        jfaults.FaultConfig(kill_step=kill)))
    try:
        eng = JaxEngine(models[0], cache_config=JaxCacheConfig(**_geom()),
                        scheduler_config=JaxSchedulerConfig(**_sched(depth)),
                        journal=journal)
    finally:
        jfaults.set_default_injector(prev)
    eng.stepprof.disable()
    return eng


def _port(models, depth=0, journal=None, kill=0):
    prev = tfaults.set_default_injector(tfaults.FaultInjector(
        tfaults.FaultConfig(kill_step=kill)))
    try:
        return GenerationEngine(
            models[1], cache_config=CacheConfig(**_geom()),
            scheduler_config=SchedulerConfig(**_sched(depth)),
            journal=journal, device="cpu")
    finally:
        tfaults.set_default_injector(prev)


def _workload(sampled, n=6, seed=5):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, VOCAB, size=int(rng.integers(4, 30))).tolist()
               for _ in range(n)]
    mnts = [int(rng.integers(6, 16)) for _ in range(n)]
    sps = [dict(SAMPLED, seed=100 + i) if sampled and i % 2 else None
           for i in range(n)]
    return prompts, mnts, sps


def _submit(eng, prompts, mnts, sps, jax_side):
    cls = JaxSP if jax_side else SamplingParams
    return [eng.submit(p, m, cls(**sp) if sp else None,
                       priority=i % 2, tenant="ab"[i % 2])
            for i, (p, m, sp) in enumerate(zip(prompts, mnts, sps))]


def _kill_run(eng, kill_exc):
    steps = 0
    with pytest.raises(kill_exc):
        while True:
            eng.step()
            steps += 1
    return steps


@pytest.mark.parametrize("sampled", [False, True])
def test_jax_journal_restores_in_the_port(models, tmp_path, sampled):
    prompts, mnts, sps = _workload(sampled)
    ref = _jax(models)
    rr = _submit(ref, prompts, mnts, sps, True)
    ref.run()
    want = [ref.output_of(r) for r in rr]
    path = str(tmp_path / "jax.pdj")
    doomed = _jax(models, journal=jj.RequestJournal(path), kill=9)
    dr = _submit(doomed, prompts, mnts, sps, True)
    assert _kill_run(doomed, jfaults.EngineKilled) == 8
    before = {r: list(doomed.scheduler.requests[r].output) for r in dr}
    doomed.journal.close()
    fresh = _port(models)
    mapping = fresh.restore(path)
    assert mapping and len(mapping) < len(dr) + 1
    fresh.run()
    got = [fresh.output_of(mapping[r]) if r in mapping else before[r]
           for r in dr]
    assert got == want
    for old, new in mapping.items():
        req = fresh.scheduler.requests[new]
        jreq = doomed.scheduler.requests[old]
        assert (req.priority, req.tenant) == (jreq.priority, jreq.tenant)


@pytest.mark.parametrize("sampled", [False, True])
def test_port_journal_restores_in_jax(models, tmp_path, sampled):
    prompts, mnts, sps = _workload(sampled, seed=8)
    ref = _port(models)
    rr = _submit(ref, prompts, mnts, sps, False)
    ref.run()
    want = [ref.output_of(r) for r in rr]
    path = str(tmp_path / "port.pdj")
    doomed = _port(models, journal=tj.RequestJournal(path), kill=7)
    dr = _submit(doomed, prompts, mnts, sps, False)
    assert _kill_run(doomed, tfaults.EngineKilled) == 6
    before = {r: list(doomed.scheduler.requests[r].output) for r in dr}
    doomed.journal.close()
    fresh = _jax(models)
    mapping = fresh.restore(path)
    fresh.run()
    got = [fresh.output_of(mapping[r]) if r in mapping else before[r]
           for r in dr]
    assert got == want


def _records(journal_mod, path, sync_every=3):
    w = journal_mod.RequestJournal(path, sync_every=sync_every)
    w.record_submit(7, [1, 2, 3], 5, SamplingParams(**SAMPLED, seed=9),
                    priority=1, tenant="t", ttft_deadline_s=0.5)
    w.record_submit(8, [4], 2)
    w.record_tokens(7, [10, 11])
    w.record_tokens(8, [12])
    w.record_finish(8, "max_new_tokens")
    w.record_tokens(7, [13])
    w.close()


def test_read_journal_of_the_other_package(tmp_path):
    tp, jp = str(tmp_path / "t.pdj"), str(tmp_path / "j.pdj")
    _records(tj, tp)
    _records(jj, jp)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    for a, b in ((tj.read_journal(jp), jj.read_journal(jp)),
                 (tj.read_journal(tp), jj.read_journal(tp))):
        assert {k: vars(v) for k, v in a.items()} == \
            {k: vars(v) for k, v in b.items()}
    e = tj.read_journal(jp)
    assert e[7].tokens == [10, 11, 13] and e[7].finish_reason is None
    assert e[7].seed == 9 and e[7].tenant == "t" and e[7].priority == 1
    assert e[8].finish_reason == "max_new_tokens"


@pytest.mark.parametrize("cut", [1, 5, 9])
def test_torn_tail_stops_at_the_last_intact_record(tmp_path, cut):
    path = str(tmp_path / "torn.pdj")
    _records(tj, path)
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:-cut])               # a frame cut mid-write
    got = tj.read_journal(path)
    assert {k: vars(v) for k, v in got.items()} == \
        {k: vars(v) for k, v in jj.read_journal(path).items()}
    assert got[7].tokens == [10, 11]       # the last record is gone
    # reopening truncates the torn tail before appending
    w = tj.RequestJournal(path)
    w.record_tokens(7, [20])
    w.close()
    assert tj.read_journal(path)[7].tokens == [10, 11, 20]


def test_crc_mismatch_stops_the_replay(tmp_path):
    path = str(tmp_path / "crc.pdj")
    _records(tj, path)
    data = bytearray(open(path, "rb").read())
    recs = list(tj.scan_records(path))
    # flip one payload byte of the third record
    off = len(tj.JOURNAL_MAGIC)
    for _ in range(2):
        off += 8 + int.from_bytes(data[off:off + 4], "little")
    data[off + 12] ^= 0x01
    open(path, "wb").write(bytes(data))
    got = list(tj.scan_records(path))
    assert got == recs[:2] == list(jj.scan_records(path))
    bad = str(tmp_path / "bad.pdj")
    open(bad, "wb").write(b"NOPE")
    with pytest.raises(ValueError):
        tj.read_journal(bad)


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("sampled", [False, True])
def test_kill_and_restore_is_bit_exact_in_the_port(models, tmp_path, depth,
                                                   sampled):
    prompts, mnts, sps = _workload(sampled, n=7, seed=13)
    ref = _port(models, depth)
    rr = _submit(ref, prompts, mnts, sps, False)
    ref.run()
    want = [ref.output_of(r) for r in rr]
    path = str(tmp_path / "kill.pdj")
    doomed = _port(models, depth, journal=tj.RequestJournal(path), kill=10)
    dr = _submit(doomed, prompts, mnts, sps, False)
    _kill_run(doomed, tfaults.EngineKilled)
    before = {r: list(doomed.scheduler.requests[r].output) for r in dr}
    doomed.journal.close()
    # the restored engine journals too, and dies once more
    path2 = str(tmp_path / "kill2.pdj")
    second = _port(models, depth, journal=tj.RequestJournal(path2), kill=4)
    m1 = second.restore(path)
    _kill_run(second, tfaults.EngineKilled)
    before2 = {r: list(second.scheduler.requests[r].output)
               for r in m1.values()}
    second.journal.close()
    third = _port(models, depth)
    m2 = third.restore(path2)
    third.run()
    got = []
    for r in dr:
        if r not in m1:
            got.append(before[r])
        elif m1[r] not in m2:
            got.append(before2[m1[r]])
        else:
            got.append(third.output_of(m2[m1[r]]))
    assert got == want
    third.cache.check_invariants()
    assert third.cache.pages_in_use == 0


def test_drain_checkpoints_the_residents(models, tmp_path):
    prompts, mnts, sps = _workload(False, n=6, seed=21)
    ref = _port(models)
    rr = _submit(ref, prompts, mnts, sps, False)
    ref.run()
    want = [ref.output_of(r) for r in rr]
    path = str(tmp_path / "drain.pdj")
    eng = _port(models, 1, journal=tj.RequestJournal(path))
    dr = _submit(eng, prompts, mnts, sps, False)
    for _ in range(7):
        eng.step()
    live = eng.drain()
    assert not eng.scheduler.running and eng.pipeline_depth == 0
    with pytest.raises(QueueFull):
        eng.submit([1, 2], 3)
    assert sorted(live) == sorted(eng.journal.live_rids())
    done = {r: eng.output_of(r) for r in dr if r not in live}
    fresh = _port(models)
    mapping = fresh.restore(path)
    assert sorted(mapping) == sorted(live)
    fresh.run()
    got = [fresh.output_of(mapping[r]) if r in mapping else done[r]
           for r in dr]
    assert got == want


def test_compaction_keeps_only_live_requests(models, tmp_path):
    path = str(tmp_path / "compact.pdj")
    journal = tj.RequestJournal(path, sync_every=1, max_bytes=4096)
    eng = _port(models, journal=journal)
    prompts, mnts, sps = _workload(False, n=12, seed=31)
    _submit(eng, prompts, mnts, sps, False)
    eng.run()
    assert journal.compactions > 0
    assert os.path.getsize(path) < 4096 + 1024
    assert _port(models).restore(path) == {}     # every request finished
    # a live request survives compaction with its tokens
    w = tj.RequestJournal(str(tmp_path / "c2.pdj"), max_bytes=4096)
    w.record_submit(1, list(range(40)), 300)
    for i in range(200):
        w.record_tokens(1, [i % VOCAB])
        w.record_submit(1000 + i, [1], 1)
        w.record_finish(1000 + i, "eos")
    w.close()
    assert w.compactions > 0
    e = tj.read_journal(str(tmp_path / "c2.pdj"))
    assert [k for k, v in e.items() if v.finish_reason is None] == [1]
    assert e[1].tokens == [i % VOCAB for i in range(200)]
    assert len(e) < 20                     # sealed requests compacted away
    assert jj.read_journal(str(tmp_path / "c2.pdj"))[1].tokens == e[1].tokens

"""A CPU rehearsal of ``chip_smoke.py``'s speculative engine phase and
its per-tier phase: the speculative engine path and the per-tier path on
a narrow model with GPT-2-small's vocabulary and context (d 64, 2
layers), the smoke's own twelve requests. It is the longest rehearsal,
so it has a file of its own. The shared stand-ins and fixtures are in
``tests/_torch_rehearsal.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_rehearsal import (  # noqa: E402,F401
    CPU, ModelSpec, TorchLM, cs, init_lm_params, pa, plain_kernels)
from _torch_threads import one_thread  # noqa: E402,F401


def test_spec_engine_and_per_tier_phases(plain_kernels):
    spec = ModelSpec(vocab=cs.GPT2_SMALL.vocab, d_model=64, num_layers=2,
                     num_heads=2, head_dim=32,
                     max_seq_len=cs.GPT2_SMALL.max_seq_len)
    model = TorchLM(spec, init_lm_params(spec, seed=0, device=CPU),
                    device=CPU)
    requests = cs.requests_spec()
    launches, teacher, diverge = cs.phase_spec_engine(model, requests)
    assert set(launches) == {"ragged_attention"}
    assert diverge == [None] * len(requests)   # one backend: equal tokens
    got = cs.phase_per_tier(model, requests, teacher, diverge)
    assert set(got) == {pa.MIXED_KERNEL, pa.PAGED_KERNEL}
    assert all(n % spec.num_layers == 0 and n > 0 for n in got.values())

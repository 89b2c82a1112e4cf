"""``GPTForCausalLM.generate`` and the GPT cache paths against the JAX
package's, on the CPU.

- The concatenating cache and the static cache (``(kbuf, vbuf,
  length)``): a prompt and three one-token steps give the logits of the
  uncached forward over the whole sequence (1e-5).
- ``generate``, greedy and sampled (temperature, top-k, top-p), from the
  same weights and seed: the port's tokens equal the JAX package's up to
  the first decision that is a near-tie in the port's own scores (the
  two best candidates closer than 1e-4: float32 GEMMs of other shapes
  and each backend's ``log`` in the Gumbel noise decide those either
  way), counted as ``tests/test_torch_sampling.py`` counts them; a
  parting that is not a near-tie fails. With ``eos_token_id`` the rows
  keep emitting eos and the tokens end once every row has; ``max_length``
  and the ``max_position_embeddings`` check as in the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpaddle  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.text import gpt as jgpt  # noqa: E402
from paddle_tpu_torch.core import threefry  # noqa: E402
from paddle_tpu_torch.text import gpt as tgpt  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

CACHE_TOL = 1e-5
NEAR_TIE = 1e-4
CFG = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=128,
           max_position_embeddings=64, hidden_dropout_prob=0.1,
           attention_probs_dropout_prob=0.1)


def _models(seed=3):
    jpaddle.seed(seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**CFG))
    tm = tgpt.gpt_params_from_jax(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()},
        tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device="cpu"))
    jm.eval()
    tm.eval()
    return jm, tm


def _prompt(B=2, P=8, seed=0):
    return np.random.default_rng(seed).integers(0, 96, (B, P)).astype(
        np.int32)


@pytest.mark.parametrize("static", [False, True])
def test_cache_paths_match_the_uncached_forward(static):
    _, tm = _models()
    ids = torch.tensor(_prompt(P=12)).long()
    with torch.no_grad():
        full = tm(ids)
        B, nh = 2, CFG["num_attention_heads"]
        hd = CFG["hidden_size"] // nh
        if static:
            caches = [(torch.zeros(B, 12, nh, hd), torch.zeros(B, 12, nh, hd),
                       0) for _ in range(CFG["num_hidden_layers"])]
        else:
            caches = [(torch.zeros(B, 0, nh, hd), torch.zeros(B, 0, nh, hd))
                      for _ in range(CFG["num_hidden_layers"])]
        h, caches = tm.gpt(ids[:, :9], caches=caches)
        got = [tm._logits(h)]
        for t in range(9, 12):
            h, caches = tm.gpt(ids[:, t:t + 1], caches=caches,
                               position_offset=t)
            got.append(tm._logits(h))
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), full.numpy(),
                               rtol=CACHE_TOL, atol=CACHE_TOL)
    if static:
        assert caches[0][2] == 12
    with pytest.raises(ValueError):
        tm.gpt(ids, caches=caches[:1])


def _port_scores(record):
    """Per recorded decision, the gap between the two best scores the
    port's sampler decided on (argmax logits, or Gumbel noise plus the
    masked logits)."""
    gaps = []
    for logits, do_sample, top_k, top_p, temp, key in record:
        if not do_sample:
            s = logits.float()
        else:
            lf = logits.float() / max(temp, 1e-6)
            lf = _masked(lf, top_k, top_p)
            s = threefry.gumbel(threefry.as_key(key), lf.shape) + lf
        top2 = torch.topk(s, 2, dim=-1)[0]
        gaps.append((top2[:, 0] - top2[:, 1]).numpy())
    return np.stack(gaps, axis=1)                       # [B, T]


def _masked(lf, top_k, top_p):
    """The sampler's top-k and top-p masking of ``lf``."""
    V = lf.shape[-1]
    k = min(int(top_k), V) if top_k else 0
    if k:
        kth = torch.topk(lf, k, dim=-1)[0][..., -1:]
        lf = torch.where(lf < kth, torch.tensor(float("-inf")), lf)
    if top_p < 1.0:
        sl = torch.sort(lf, dim=-1, descending=True)[0]
        p = torch.softmax(sl, -1)
        keep = torch.cumsum(p, -1) - p < top_p
        kth = torch.gather(sl, -1, keep.sum(-1, keepdim=True) - 1)
        lf = torch.where(lf < kth, torch.tensor(float("-inf")), lf)
    return lf


def _generate_both(monkeypatch, **kw):
    jm, tm = _models()
    prompt = _prompt()
    record = []
    real = tgpt.GPTForCausalLM._pick_device

    def spy(logits, do_sample, top_k, top_p, temperature, key):
        record.append((logits.clone(), do_sample, top_k, top_p, temperature,
                       key))
        return real(logits, do_sample, top_k, top_p, temperature, key)

    monkeypatch.setattr(tgpt.GPTForCausalLM, "_pick_device",
                        staticmethod(spy))
    got = tm.generate(torch.tensor(prompt), **kw).numpy()
    want = np.asarray(jm.generate(Tensor(jnp.asarray(prompt)), **kw)._value)
    return got, want, _port_scores(record), prompt.shape[1]


def _equal_up_to_near_ties(got, want, gaps, P):
    """Each row's tokens equal until its first near-tie decision; a
    parting before that fails. Returns the count of near-ties hit."""
    ties = 0
    assert got.shape == want.shape
    for b in range(got.shape[0]):
        tie = np.nonzero(gaps[b] < NEAR_TIE)[0]
        stop = P + (int(tie[0]) if len(tie) else gaps.shape[1])
        ties += bool(len(tie))
        np.testing.assert_array_equal(got[b, :stop], want[b, :stop])
    return ties


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=12),
    dict(max_new_tokens=12, do_sample=True, seed=5),
    dict(max_new_tokens=12, do_sample=True, top_k=10, temperature=0.7,
         seed=11),
    dict(max_new_tokens=12, do_sample=True, top_p=0.8, seed=2),
    dict(max_new_tokens=10, do_sample=True, top_k=20, top_p=0.9,
         temperature=1.3, seed=7),
    dict(max_length=15),
], ids=["greedy", "sampled", "top_k", "top_p", "top_k_top_p", "max_length"])
def test_generate_matches_jax(monkeypatch, kw):
    got, want, gaps, P = _generate_both(monkeypatch, **kw)
    _equal_up_to_near_ties(got, want, gaps, P)


def test_generate_eos_truncation_matches_jax(monkeypatch):
    """eos: the greedy run's third token is made the eos id, so every
    row that emits it repeats it, and the tokens end at the last row's
    first eos (if every row has one) as in the JAX package."""
    _, tm = _models()
    first = tm.generate(torch.tensor(_prompt()), max_new_tokens=6).numpy()
    eos = int(first[0, 8 + 2])
    got, want, gaps, P = _generate_both(monkeypatch, max_new_tokens=6,
                                        eos_token_id=eos)
    _equal_up_to_near_ties(got, want, gaps, P)
    assert (got[0, P + 2:] == eos).all()


def test_generate_refuses_positions_past_the_table():
    _, tm = _models()
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm.generate(torch.tensor(_prompt()), max_new_tokens=60)
    with pytest.raises(ValueError, match="max_length"):
        tm.generate(torch.tensor(_prompt()), max_length=4)


def test_pick_host_twin_matches_jax():
    """``_pick`` (numpy logits, a numpy generator) is the JAX package's
    ``_pick``: the same draws from the same generator state."""
    logits = np.random.default_rng(1).standard_normal((3, 40))
    for kw in (dict(do_sample=False, top_k=0, top_p=1.0, temperature=1.0),
               dict(do_sample=True, top_k=5, top_p=0.9, temperature=0.8)):
        got = tgpt.GPTForCausalLM._pick(logits, rng=np.random.default_rng(4),
                                        **kw)
        want = jgpt.GPTForCausalLM._pick(logits,
                                         rng=np.random.default_rng(4), **kw)
        np.testing.assert_array_equal(got, want)

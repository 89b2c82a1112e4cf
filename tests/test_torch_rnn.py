"""The port's recurrent layers against the JAX package's, on the CPU.

The JAX layer's weights carried over by name; inputs from a numpy seed.
Tolerances: outputs and final states within 1e-5, gradients within 1e-4
(relative).

- ``SimpleRNNCell`` (tanh and relu), ``LSTMCell`` and ``GRUCell`` one
  step, with and without biases;
- ``SimpleRNN`` / ``LSTM`` / ``GRU``: two layers, forward and
  bidirectional, batch- and time-major, ``sequence_length`` (finished
  rows keep their carry and output zeros), given initial states, and
  the gradients of inputs, states and every weight;
- ``RNN`` over a cell the fused loop does not know (the step-by-step
  path) and ``BiRNN``;
- dropout between the layers in training: the threefry masks are the
  JAX package's bits;
- ``chip_smoke.make_lstm_lm`` (the smoke's Zaremba LM at a small width)
  in training: the loss from one seed;
- ``BeamSearchDecoder`` + ``dynamic_decode`` over an ``LSTMCell``: ids
  and scores equal to the JAX package's at batch 1, and at batch 2,
  where the JAX loop reorders every row by row 0's beams (a reference
  quirk the port keeps, ROADMAP queue C).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.core.random as jrandom  # noqa: E402

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.core import random as trandom  # noqa: E402
from paddle_tpu_torch.nn import layer_state_from_jax  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL, GRAD_RTOL = 1e-5, 1e-4
IN, HID, BATCH, STEPS = 5, 6, 3, 7


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(a) for a in x]
    return np.asarray(x.numpy())


def _close(got, want, name, rtol=TOL, atol=TOL):
    if isinstance(want, list):
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            _close(g, w, name, rtol, atol)
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=name)


def _carried(make):
    jl, tl = make(jp.nn), make(tp.nn)
    layer_state_from_jax({k: _np(v) for k, v in jl.state_dict().items()},
                         tl)
    return jl, tl


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [leaf for a in x for leaf in _leaves(a)]
    return [x]


def _run(p, layer, args, grad_args):
    """Outputs and the gradients of (inputs, states, weights) of the sum
    of squares of every output leaf."""
    ts = [p.to_tensor(a, stop_gradient=i not in grad_args)
          if isinstance(a, np.ndarray) else a for i, a in enumerate(args)]
    states = ts[1]
    if isinstance(states, list):
        states = tuple(p.to_tensor(s, stop_gradient=False) for s in states)
        ts[1] = states
    out = layer(*ts)
    leaves = _leaves(out)
    total = leaves[0].sum() * 0
    for leaf in leaves:
        total = total + (leaf * leaf).sum()
    total.backward()
    grads = {n: _np(q.grad) for n, q in layer.named_parameters()}
    grads["x"] = _np(ts[0].grad)
    if isinstance(states, tuple):
        grads.update({f"s{i}": _np(s.grad) for i, s in enumerate(states)})
    return [_np(leaf) for leaf in leaves], grads


CELLS = {
    "simple_tanh": lambda n: n.SimpleRNNCell(IN, HID),
    "simple_relu": lambda n: n.SimpleRNNCell(IN, HID, activation="relu"),
    "lstm": lambda n: n.LSTMCell(IN, HID),
    "gru": lambda n: n.GRUCell(IN, HID),
    "lstm_nobias": lambda n: n.LSTMCell(IN, HID, bias_ih_attr=False),
    "gru_nobias": lambda n: n.GRUCell(IN, HID, bias_hh_attr=False),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_step_matches_jax(name):
    r = np.random.RandomState(1)
    x = r.randn(BATCH, IN).astype("float32")
    h = r.randn(BATCH, HID).astype("float32")
    states = [h, r.randn(BATCH, HID).astype("float32")] \
        if name.startswith("lstm") else h
    jl, tl = _carried(CELLS[name])
    want, wg = _run(jp, jl, [x, states], {0, 1})
    got, tg = _run(tp, tl, [x, states], {0, 1})
    _close(got, want, name)
    for k, g in wg.items():
        _close(tg[k], g, f"{name}.{k}", GRAD_RTOL, 1e-6)


NETS = {
    "simple_rnn": lambda n: n.SimpleRNN(IN, HID, 2),
    "simple_rnn_relu_bi": lambda n: n.SimpleRNN(IN, HID, 2, "bidirect",
                                                activation="relu"),
    "lstm": lambda n: n.LSTM(IN, HID, 2),
    "lstm_bi": lambda n: n.LSTM(IN, HID, 2, "bidirectional"),
    "lstm_time_major": lambda n: n.LSTM(IN, HID, 2, time_major=True),
    "gru": lambda n: n.GRU(IN, HID, 2),
    "gru_bi_time_major": lambda n: n.GRU(IN, HID, 1, "bidirect",
                                         time_major=True),
}


@pytest.mark.parametrize("initial,lengths", [(False, False), (True, True)],
                         ids=["zero-full", "given-lengths"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_rnn_layers_match_jax(name, initial, lengths):
    jl, tl = _carried(NETS[name])
    r = np.random.RandomState(2)
    tm = "time_major" in name
    x = r.randn(*((STEPS, BATCH, IN) if tm else (BATCH, STEPS, IN))
                ).astype("float32")
    n_states = jl.num_layers * jl.num_directions
    states = None
    if initial:
        h = r.randn(n_states, BATCH, HID).astype("float32")
        states = [h, r.randn(n_states, BATCH, HID).astype("float32")] \
            if name.startswith("lstm") else h
    seq = np.array([7, 3, 5], "int64") if lengths else None
    outs = []
    for p, layer in ((jp, jl), (tp, tl)):
        args = [x, states, None if seq is None else p.to_tensor(seq)]
        outs.append(_run(p, layer, args, {0, 1} if initial else {0}))
    (want, wg), (got, tg) = outs
    _close(got, want, name)
    assert set(tg) == set(wg)
    for k, g in wg.items():
        _close(tg[k], g, f"{name}.{k}", GRAD_RTOL, 1e-6)
    if lengths:
        out = got[0] if not tm else got[0].transpose(1, 0, 2)
        assert np.all(out[1, 3:] == 0)          # finished rows output 0


def test_state_dict_names_match_jax():
    for make in NETS.values():
        jl, tl = make(jp.nn), make(tp.nn)
        assert list(tl.state_dict()) == list(jl.state_dict())


class _Doubler:
    """A cell the fused loop does not know: the generic step loop."""

    @staticmethod
    def make(nn):
        class Cell(nn.LSTMCell):
            def forward(self, inputs, states=None):
                h, (h2, c2) = super().forward(inputs, states)
                return h * 2, (h2, c2)
        return nn.RNN(Cell(IN, HID), is_reverse=True)


def test_rnn_over_an_unknown_cell_and_birnn_match_jax():
    r = np.random.RandomState(3)
    x = r.randn(BATCH, STEPS, IN).astype("float32")
    seq = np.array([2, 7, 4], "int64")
    for make in (_Doubler.make, lambda n: n.BiRNN(n.GRUCell(IN, HID),
                                                  n.GRUCell(IN, HID))):
        jl, tl = _carried(make)
        want = _np(_leaves(jl(jp.to_tensor(x), None, jp.to_tensor(seq))))
        got = _np(_leaves(tl(tp.to_tensor(x), None, tp.to_tensor(seq))))
        _close(got, want, "rnn")


def test_dropout_between_layers_is_the_jax_bits():
    jl, tl = _carried(lambda n: n.LSTM(IN, HID, 3, dropout=0.4))
    x = np.random.RandomState(4).randn(BATCH, STEPS, IN).astype("float32")
    jrandom.seed(12)
    trandom.default_generator.manual_seed(12)
    want = _np(_leaves(jl(jp.to_tensor(x))))
    got = _np(_leaves(tl(tp.to_tensor(x))))
    _close(got, want, "dropout")
    tl.eval()
    assert not np.allclose(_np(tl(tp.to_tensor(x))[0]), got[0], atol=1e-4)


LM = dict(vocab=50, hidden=16, layers=2, dropout=0.65, init=0.04)


def test_lstm_lm_loss_from_one_seed_matches_jax():
    jl, tl = _carried(lambda n: cs.make_lstm_lm(
        jp if n is jp.nn else tp, **LM))
    r = np.random.RandomState(5)
    x = r.randint(0, LM["vocab"], (4, 9)).astype("int64")
    y = r.randint(0, LM["vocab"], (4, 9)).astype("int64")
    losses = []
    for p, m, seed in ((jp, jl, jrandom.seed),
                       (tp, tl, trandom.default_generator.manual_seed)):
        seed(3)
        loss, _ = cs.lstm_loss(p, m, p.to_tensor(x), p.to_tensor(y))
        losses.append(float(loss.numpy()))
    np.testing.assert_allclose(losses[1], losses[0], rtol=TOL)


@pytest.mark.parametrize("batch", [1, 2])
def test_dynamic_decode_matches_jax(batch):
    """Beam search of 3 over an LSTMCell with an embedding and a
    projection: ids and scores equal to the JAX package's. At batch 2
    the JAX loop's reordering by row 0's beams is kept as it is."""
    r = np.random.RandomState(6)
    emb = r.randn(12, 8).astype("float32")
    proj = r.randn(8, 12).astype("float32")
    outs = []
    for p in (jp, tp):
        cell = p.nn.LSTMCell(8, 8)
        if p is jp:
            state = {k: _np(v) for k, v in cell.state_dict().items()}
        else:
            cell.set_state_dict(state)
        e, w = p.to_tensor(emb), p.to_tensor(proj)
        dec = p.nn.BeamSearchDecoder(
            cell, 1, 2, 3, embedding_fn=lambda ids, e=e, p=p:
            p.nn.functional.embedding(ids, e),
            output_fn=lambda h, w=w, p=p: p.matmul(h, w))
        inits = cell.get_initial_states(p.zeros([batch, 8]))
        ids, scores = p.nn.dynamic_decode(dec, inits, max_step_num=6)
        outs.append((_np(ids), _np(scores)))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-6, atol=1e-6)

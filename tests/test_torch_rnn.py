"""The port's recurrent layers, seq2seq decoding and an attention seq2seq
against the JAX package's, on the same numpy inputs and weights.

Every recurrent class runs forward and backward in both packages: the
port's autograd gradients (the input, the initial states and every
weight) against ``jax.vjp`` of the reference's compiled ``_rnn_scan`` /
cell ops, or ``jax.grad`` of its compiled ``functional_call`` (``RNN``,
``BiRNN``), on the same random cotangents. Each class is run in both
``time_major`` settings, both directions (both spellings of the
bidirectional one) and 2 layers, with and without initial states.
Tolerance: ``rtol = 1e-5`` of the largest magnitude for an op, ``1e-4``
for the seq2seq model; a bf16 cell within 1e-2 (its products round to 8
bits). Beam search ids, and ``gather_tree``'s, must be equal, ties
included: all-equal logits make every candidate tie, and both packages
then take them lowest flat index first.

The seq2seq is ``chip_smoke.py``'s phase-14 model (``Seq2Seq``, built from
the port's ``nn``) at tiny widths, against the same model written with the
reference's ``nn``: its loss, every gradient, two ``Adam`` steps with
``ClipGradByGlobalNorm`` engaged, and its beam search ids.

The reference builds its layers with zero weights (its JAX initialisers
compile once per shape); the weights are drawn with numpy and carried
into the port by ``models.convert.load_jax_state``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn import decode as jdecode
from paddle_tpu.nn import functional as jF
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.nn.layers import rnn as jrnn
from paddle_tpu_torch import nn
from paddle_tpu_torch.models import export_state, load_jax_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.parallel import TrainStep
from torch_threads import one_torch_thread  # noqa: F401

RTOL, MODEL_RTOL, BF16_RTOL = 1e-5, 1e-4, 1e-2
IN, HID, BATCH, STEPS = 5, 6, 3, 4


def close(got, want, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(getattr(want, "_value", want), dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(scale, 1e-6))


def _rand(rng, shape, scale=1.0):
    return ((rng.rand(*shape) * 2 - 1) * scale).astype(np.float32)


@pytest.fixture(autouse=True)
def zero_init(monkeypatch):
    def create(self, shape, dtype=None, name=None):
        return JaxParameter(np.zeros(tuple(int(s) for s in shape),
                                     np.float32), name=name)
    monkeypatch.setattr(jinit.Initializer, "create", create)


def seed_weights(jlayer, layer, rng, scale=0.5):
    """Weights from ``rng`` into the reference layer and, by name, the
    port's; returns the reference's (names, values)."""
    names, values = jlayer.functional_state()
    values = [_rand(rng, np.shape(v), scale) for v in values]
    tensors = jlayer.raw_state_tensors()
    for n, v in zip(names, values):
        tensors[n]._value = jnp.asarray(v)
    load_jax_state(layer, names, values)
    assert export_state(layer)[0] == names
    return names, values


# -- LSTM / GRU / SimpleRNN over _rnn_scan --------------------------------

# (class, kwargs, time_major, with initial states): each class sees both
# settings of each axis
RNN_CASES = [
    ("LSTM", dict(direction="bidirect"), False, True),
    ("LSTM", {}, True, False),
    ("GRU", dict(direction="bidirectional"), True, True),
    ("GRU", {}, False, False),
    ("SimpleRNN", dict(direction="bidirect", activation="relu"), False,
     False),
    ("SimpleRNN", {}, True, True),
]


@pytest.mark.parametrize("case", range(len(RNN_CASES)),
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(RNN_CASES)])
def test_multilayer_rnn_matches_reference(case):
    name, kw, tm, with_states = RNN_CASES[case]
    rng = np.random.RandomState(case)
    jlayer = getattr(jnn, name)(IN, HID, num_layers=2, time_major=tm, **kw)
    layer = getattr(nn, name)(IN, HID, num_layers=2, time_major=tm,
                              device="cpu", **kw)
    names, weights = seed_weights(jlayer, layer, rng)
    n = 2 * layer.num_directions
    lstm = name == "LSTM"
    x = _rand(rng, (STEPS, BATCH, IN) if tm else (BATCH, STEPS, IN))
    h0, c0 = _rand(rng, (n, BATCH, HID)), _rand(rng, (n, BATCH, HID))
    states = ([h0, c0] if lstm else [h0]) if with_states else []
    mode = {"SimpleRNN": "RNN"}.get(name, name)
    direction = "bidirect" if n == 4 else "forward"

    def ref(x, weights, *states):
        zeros = jnp.zeros((n, BATCH, HID), jnp.float32)
        h, c = (states + (zeros, zeros))[:2] if lstm else (
            (states or (zeros,))[0], None)
        return jrnn._rnn_scan.raw_fn(
            x, h, c if lstm else None, list(weights), mode=mode,
            num_layers=2, direction=direction, time_major=tm,
            activation=layer.activation)

    want = jax.jit(ref)(x, weights, *states)
    gs = [_rand(np.random.RandomState(100 + i), np.shape(w))
          for i, w in enumerate(want)]
    grads = jax.jit(lambda *a: jax.vjp(ref, *a)[1](tuple(gs)))(
        x, weights, *states)
    xt = torch.tensor(x, requires_grad=True)
    st = [torch.tensor(s, requires_grad=True) for s in states]
    init = (tuple(st) if lstm else st[0]) if st else None
    out, final = layer(xt, init)
    got = [out] + (list(final) if lstm else [final])
    for g, w in zip(got, want):
        close(g, w)
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, gs)).backward()
    close(xt.grad, grads[0])
    params = dict(layer.named_parameters())
    for nm, gw in zip(names, grads[1]):
        close(params[nm].grad, gw)
    for s, gw in zip(st, grads[2:]):
        close(s.grad, gw)


def test_reference_faults_raise(monkeypatch):
    """``dropout`` and the ``*_attr`` arguments are not applied by the
    reference ("Faults of the reference" 12): the port refuses them."""
    for make in (lambda: nn.LSTM(4, 5, 2, dropout=0.1, device="cpu"),
                 lambda: nn.GRU(4, 5, weight_ih_attr=nn.ParamAttr(),
                                device="cpu"),
                 lambda: nn.SimpleRNN(4, 5, bias_hh_attr=False,
                                      device="cpu"),
                 lambda: nn.LSTMCell(4, 5, weight_hh_attr=nn.ParamAttr(),
                                     device="cpu"),
                 lambda: nn.GRUCell(4, 5, bias_ih_attr=False, device="cpu")):
        with pytest.raises(NotImplementedError,
                           match="Faults of the reference' 12"):
            make()
    nn.LSTM(4, 5, 2, dropout=0.0, name=None, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: nn.GRUCell(4, 5), lambda: nn.LSTM(4, 5)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# -- the cells -------------------------------------------------------------

CELLS = [("LSTMCell", {}, jrnn._lstm_cell_op), ("GRUCell", {},
                                                 jrnn._gru_cell_op),
         ("SimpleRNNCell", {}, jrnn._simple_cell_op),
         ("SimpleRNNCell", dict(activation="relu"), jrnn._simple_cell_op)]


@pytest.mark.parametrize("case", range(len(CELLS)))
@pytest.mark.parametrize("with_states", [True, False])
def test_cells_match_reference(case, with_states):
    name, kw, op = CELLS[case]
    rng = np.random.RandomState(10 + case)
    jcell = getattr(jnn, name)(IN, HID, **kw)
    cell = getattr(nn, name)(IN, HID, device="cpu", **kw)
    assert [n for n, _ in cell.named_parameters()] == [
        "weight_ih", "weight_hh", "bias_ih", "bias_hh"]
    names, weights = seed_weights(jcell, cell, rng)
    lstm = name == "LSTMCell"
    x = _rand(rng, (BATCH, IN))
    zeros = np.zeros((BATCH, HID), np.float32)
    states = ([_rand(rng, (BATCH, HID)) for _ in range(2 if lstm else 1)]
              if with_states else [zeros] * (2 if lstm else 1))
    extra = dict(activation=kw.get("activation", "tanh")) \
        if name == "SimpleRNNCell" else {}

    def ref(x, states, weights):
        return op.raw_fn(x, *states, *weights, **extra)

    want = jax.jit(ref)(x, states, weights)
    want = want if lstm else (want,)
    gs = [_rand(np.random.RandomState(200 + i), np.shape(w))
          for i, w in enumerate(want)]
    grads = jax.jit(lambda *a: jax.vjp(ref, *a)[1](
        tuple(gs) if lstm else gs[0]))(x, states, weights)
    xt = torch.tensor(x, requires_grad=True)
    st = [torch.tensor(s, requires_grad=True) for s in states]
    init = (tuple(st) if lstm else st[0]) if with_states else None
    out, new = cell(xt, init)
    got = list(new) if lstm else [new]
    assert out is got[0]
    for g, w in zip(got, want):
        close(g, w)
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, gs)).backward()
    close(xt.grad, grads[0])
    if with_states:
        for s, gw in zip(st, grads[1]):
            close(s.grad, gw)
    params = dict(cell.named_parameters())
    for nm, gw in zip(names, grads[2]):
        close(params[nm].grad, gw)


def test_bf16_cell_without_states_computes_in_float32():
    """``get_initial_states`` is float32 whatever the input, and JAX
    promotes the bf16 products against it: the port casts, as JAX
    promotes, instead of refusing the mixed matmul."""
    rng = np.random.RandomState(20)
    jcell = jnn.LSTMCell(IN, HID)
    cell = nn.LSTMCell(IN, HID, device="cpu")
    _, weights = seed_weights(jcell, cell, rng)
    cell.to(torch.bfloat16)
    x = _rand(rng, (BATCH, IN))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert cell.get_initial_states(xb).dtype == torch.float32
    h, (h2, c) = cell(xb)
    assert h.dtype == c.dtype == torch.float32
    w16 = [jnp.asarray(w, jnp.bfloat16) for w in weights]
    zeros = jnp.zeros((BATCH, HID), jnp.float32)
    want_h, want_c = jrnn._lstm_cell_op.raw_fn(
        jnp.asarray(x, jnp.bfloat16), zeros, zeros, *w16)
    assert want_h.dtype == jnp.float32
    close(h, want_h, BF16_RTOL)
    close(c, want_c, BF16_RTOL)
    assert cell.get_initial_states(xb, dtype="bfloat16").dtype == \
        torch.bfloat16


# -- RNN and BiRNN over cells ---------------------------------------------

def _wrapped(lib, kind, **kw):
    if kind == "rnn_lstm":
        return lib.RNN(lib.LSTMCell(IN, HID, **kw))
    if kind == "rnn_gru_reverse":
        return lib.RNN(lib.GRUCell(IN, HID, **kw), is_reverse=True,
                       time_major=True)
    return lib.BiRNN(lib.LSTMCell(IN, HID, **kw),
                     lib.SimpleRNNCell(IN, HID, **kw))


@pytest.mark.parametrize("kind", ["rnn_lstm", "rnn_gru_reverse", "birnn"])
def test_rnn_wrappers_match_reference(kind):
    """Outputs, final states and every gradient; the reference's state
    names (``cell.*``, ``rnn_fw.cell.*``) carry across."""
    rng = np.random.RandomState(30)
    jlayer, layer = _wrapped(jnn, kind), _wrapped(nn, kind, device="cpu")
    names, values = seed_weights(jlayer, layer, rng)
    tm = kind == "rnn_gru_reverse"
    x = _rand(rng, (STEPS, BATCH, IN) if tm else (BATCH, STEPS, IN))
    init = None
    if kind == "rnn_lstm":
        init = (_rand(rng, (BATCH, HID)), _rand(rng, (BATCH, HID)))

    def flat(out, states):
        if isinstance(states, (tuple, list)):
            return [out] + [t for s in states for t in (
                s if isinstance(s, (tuple, list)) else (s,))]
        return [out, states]

    def ref(values, x):
        with jlayer.bind_state(names, values):
            st = None if init is None else tuple(JaxTensor(s) for s in init)
            out = flat(*jlayer(JaxTensor(x), st))
        return [o._value for o in out]

    want = jax.jit(ref)(values, x)
    gs = [_rand(np.random.RandomState(300 + i), np.shape(w))
          for i, w in enumerate(want)]
    grads = jax.jit(lambda v, x: jax.vjp(ref, v, x)[1](gs))(values, x)
    xt = torch.tensor(x, requires_grad=True)
    got = flat(*layer(xt, None if init is None else tuple(
        torch.from_numpy(s) for s in init)))
    for g, w in zip(got, want):
        close(g, w)
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, gs)).backward()
    close(xt.grad, grads[1])
    params = dict(layer.named_parameters())
    for nm, gw in zip(names, grads[0]):
        close(params[nm].grad, gw)


# -- decoding --------------------------------------------------------------

VOCAB, EMB, BEAM = 9, 4, 3


def _decoder_pair(rng, constant_logits=False):
    """A beam decoder over an LSTMCell with an embedding and an output
    layer, in both packages, on the same weights."""
    jparts = jnn.LayerList([jnn.LSTMCell(EMB, HID), jnn.Embedding(VOCAB, EMB),
                            jnn.Linear(HID, VOCAB)])
    parts = nn.LayerList([
        nn.LSTMCell(EMB, HID, device="cpu"),
        nn.Embedding(VOCAB, EMB, generator=torch.Generator(), device="cpu"),
        nn.Linear(HID, VOCAB, generator=torch.Generator(), device="cpu")])
    seed_weights(jparts, parts, rng, scale=1.0)
    if constant_logits:
        jout = lambda h: JaxTensor(jnp.zeros((h.shape[0], VOCAB)))  # noqa
        out = lambda h: torch.zeros(h.shape[0], VOCAB)  # noqa
    else:
        jout, out = jparts[2], parts[2]
    jdec = jnn.BeamSearchDecoder(jparts[0], 0, 1, BEAM, embedding_fn=jparts[1],
                                 output_fn=jout)
    dec = nn.BeamSearchDecoder(parts[0], 0, 1, BEAM, embedding_fn=parts[1],
                               output_fn=out)
    return jdec, dec


def _raw(x):
    return getattr(x, "_value", x)


def ref_dynamic_decode(jdec, inits, max_step_num):
    """The reference's ``dynamic_decode`` loop over its decoder, each
    ``step`` compiled as one program (op-by-op dispatch compiles every op
    on its own, seconds a decode): ``(ids [batch, time, beam], final
    states)``."""
    def step(inputs, states, scores, finished):
        (tok, par), inputs, states, (scores, finished) = jdec.step(
            0, JaxTensor(inputs), [JaxTensor(s) for s in states],
            (scores, finished))
        return tok, par, _raw(inputs), [_raw(s) for s in states], scores, \
            finished

    step = jax.jit(step)
    inputs, states, (scores, finished) = jdec.initialize(inits)
    inputs, states = _raw(inputs), [_raw(s) for s in states]
    tokens, parents = [], []
    for _ in range(max_step_num):
        tok, par, inputs, states, scores, finished = step(
            inputs, states, scores, finished)
        tokens.append(np.asarray(tok))
        parents.append(np.asarray(par))
        if bool(np.asarray(finished).all()):
            break
    ids = jdecode.gather_tree(np.stack(tokens), np.stack(parents))
    return np.swapaxes(np.asarray(ids._value), 0, 1), states


def test_reference_decode_loop_is_dynamic_decode():
    """``ref_dynamic_decode`` gives the reference's own ``dynamic_decode``
    ids (checked once, eagerly, at 3 steps of all-tied candidates)."""
    rng = np.random.RandomState(43)
    jdec, _ = _decoder_pair(rng, constant_logits=True)
    h0 = JaxTensor(jnp.asarray(_rand(rng, (2, HID))))
    want, _ = jnn.dynamic_decode(jdec, inits=[h0, h0], max_step_num=3)
    got, _ = ref_dynamic_decode(jdec, [h0, h0], 3)
    np.testing.assert_array_equal(got, np.asarray(want._value))


@pytest.mark.parametrize("ties", [False, True])
def test_beam_search_matches_reference(ties):
    """``dynamic_decode`` ids ``[batch, time, beam]`` and the merged final
    states; with constant logits every candidate ties, and the first step
    keeps tokens 0, 1, 2 of beam 0, lowest flat index first."""
    rng = np.random.RandomState(40)
    jdec, dec = _decoder_pair(rng, ties)
    h0, c0 = _rand(rng, (2, HID)), _rand(rng, (2, HID))
    jids, jstates = ref_dynamic_decode(
        jdec, [JaxTensor(jnp.asarray(h0)), JaxTensor(jnp.asarray(c0))], 6)
    with torch.no_grad():
        ids, states = nn.dynamic_decode(
            dec, inits=[torch.from_numpy(h0), torch.from_numpy(c0)],
            max_step_num=6)
    np.testing.assert_array_equal(ids.numpy(), jids)
    assert ids.shape[0] == 2 and ids.shape[2] == BEAM
    for s, w in zip(states, jstates):
        close(s, w)
    if ties:
        first = dec.step(0, *dec.initialize(
            [torch.from_numpy(h0), torch.from_numpy(c0)]))[0][0]
        assert first.tolist() == [[0, 1, 2], [0, 1, 2]]


def test_beam_decoder_step_and_tile():
    rng = np.random.RandomState(41)
    x = _rand(rng, (2, 3))
    np.testing.assert_array_equal(
        nn.BeamSearchDecoder.tile_beam_merge_with_batch(
            torch.from_numpy(x), 3).numpy(),
        np.asarray(jnn.BeamSearchDecoder.tile_beam_merge_with_batch(
            JaxTensor(jnp.asarray(x)), 3)._value))
    jdec, dec = _decoder_pair(rng)
    h0 = _rand(rng, (2, HID))
    jstate = jdec.initialize([JaxTensor(jnp.asarray(h0))] * 2)
    state = dec.initialize([torch.from_numpy(h0)] * 2)
    for t in range(3):
        (jtok, jpar), *jstate = jdec.step(t, *jstate)
        with torch.no_grad():
            (tok, par), *state = dec.step(t, *state)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(par.numpy(), np.asarray(jpar))
        close(state[2][0], jstate[2][0])
        np.testing.assert_array_equal(state[2][1].numpy(),
                                      np.asarray(jstate[2][1]))


def test_gather_tree_matches_reference():
    rng = np.random.RandomState(42)
    ids = rng.randint(0, 9, (5, 2, 3))
    parents = rng.randint(0, 3, (5, 2, 3))
    got = F.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jdecode.gather_tree(ids, parents)._value))
    assert F.gather_tree is nn.decode.gather_tree


# -- the phase-14 seq2seq at tiny widths ------------------------------------

TINY = dict(src_vocab=13, tgt_vocab=11, embed=4, hidden=6, layers=2)


class RefCell(jnn.Layer):
    """``chip_smoke.Seq2SeqCell`` written with the reference's ``nn``."""

    def __init__(self, embed, hidden, layers):
        super().__init__()
        self.hidden_size = hidden
        self.lstm_cells = jnn.LayerList([
            jnn.LSTMCell(embed + hidden if i == 0 else hidden, hidden)
            for i in range(layers)])
        self.attention = jnn.Linear(2 * hidden, hidden, bias_attr=False)
        self.memory = self.memory_bias = None

    def bind(self, memory, lengths):
        mask = jF.sequence_mask(lengths, memory.shape[1], dtype="float32")
        self.memory, self.memory_bias = memory, (mask - 1.0) * 1e9

    def forward(self, step_input, states):
        x = paddle.concat([step_input, states[-1]], -1)
        new = []
        for i, cell in enumerate(self.lstm_cells):
            x, (h, c) = cell(x, (states[2 * i], states[2 * i + 1]))
            new += [h, c]
        scores = paddle.matmul(x.unsqueeze(1), self.memory, transpose_y=True)
        attn = jF.softmax(scores.squeeze(1) + self.memory_bias, axis=-1)
        context = paddle.matmul(attn.unsqueeze(1), self.memory).squeeze(1)
        out = paddle.tanh(self.attention(paddle.concat([context, x], -1)))
        return out, new + [out]


class RefSeq2Seq(jnn.Layer):
    """``chip_smoke.Seq2Seq`` written with the reference's ``nn``."""

    def __init__(self, src_vocab, tgt_vocab, embed, hidden, layers):
        super().__init__()
        self.src_embedder = jnn.Embedding(src_vocab, embed)
        self.encoder = jnn.LSTM(embed, hidden, num_layers=layers)
        self.tgt_embedder = jnn.Embedding(tgt_vocab, embed)
        self.decoder = jnn.RNN(RefCell(embed, hidden, layers))
        self.output_layer = jnn.Linear(hidden, tgt_vocab, bias_attr=False)

    def encode(self, src):
        memory, (h, c) = self.encoder(self.src_embedder(src))
        states = [s for i in range(h.shape[0]) for s in (h[i], c[i])]
        return memory, states + [paddle.zeros_like(h[0])]

    def forward(self, src, src_len, tgt_in, tgt_len=None, labels=None):
        memory, states = self.encode(src)
        self.decoder.cell.bind(memory, src_len)
        out, _ = self.decoder(self.tgt_embedder(tgt_in), states)
        logits = self.output_layer(out)
        if labels is None:
            return logits
        mask = jF.sequence_mask(tgt_len, labels.shape[1], dtype="float32")
        ce = jF.cross_entropy(logits, labels, reduction="none")
        return (ce.reshape(labels.shape) * mask).sum() / labels.shape[0]


@pytest.fixture(scope="module")
def seq2seq_pair():
    saved = jinit.Initializer.create

    def create(self, shape, dtype=None, name=None):
        return JaxParameter(np.zeros(tuple(int(s) for s in shape),
                                     np.float32), name=name)

    jinit.Initializer.create = create
    try:
        jmodel = RefSeq2Seq(**TINY)
    finally:
        jinit.Initializer.create = saved
    model = chip_smoke.Seq2Seq(**TINY, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(50)
    names, values = jmodel.functional_state()
    values = [_rand(rng, np.shape(v), chip_smoke.S2S_INIT) for v in values]
    load_jax_state(model, names, values)
    return jmodel, model, names, values


def _tiny_batch(seed):
    rng = np.random.RandomState(seed)
    src_len, tgt_len = np.array([5, 2, 4]), np.array([4, 3, 1])
    src = np.where(np.arange(5) < src_len[:, None],
                   rng.randint(3, TINY["src_vocab"], (3, 5)), 0)
    labels = np.where(np.arange(4) < tgt_len[:, None],
                      rng.randint(3, TINY["tgt_vocab"], (3, 4)), 0)
    tgt_in = np.concatenate([np.ones((3, 1), np.int64), labels[:, :-1]], 1)
    return src, src_len, tgt_in, tgt_len, labels


def test_seq2seq_port_matches_reference_model(seq2seq_pair):
    """Logits, loss, every gradient, two Adam steps with the global norm
    clipped (at 0.01, so that the clip engages) and the beam ids."""
    jmodel, model, names, values = seq2seq_pair
    model = chip_smoke.Seq2Seq(**TINY, device="cpu",
                               generator=torch.Generator())
    load_jax_state(model, names, values)
    batch = _tiny_batch(51)

    def loss_of(values, *batch):
        with jmodel.bind_state(names, values):
            return jmodel(*[JaxTensor(jnp.asarray(b)) for b in batch])._value

    with jmodel.bind_state(names, values):
        jlogits = jax.jit(lambda v, *b: loss_of(v, *b))(values, *batch[:3])
    close(model(*[torch.from_numpy(b) for b in batch[:3]]), jlogits,
          MODEL_RTOL)
    jopt = paddle.optimizer.Adam(learning_rate=1e-3,
                                 parameters=jmodel.parameters(),
                                 grad_clip=jnn.ClipGradByGlobalNorm(0.01))
    grad_fn = jax.jit(jax.value_and_grad(loss_of))
    apply = jax.jit(lambda p, g, s, step: jopt.functional_apply(
        p, g, s, step=step))
    state = jopt.functional_init(dict(zip(names, values)))
    opt = Adam(learning_rate=1e-3, parameters=model.parameters(),
               grad_clip=nn.ClipGradByGlobalNorm(0.01))
    step = TrainStep(model, None, opt, labels_to_model=True, device="cpu")
    p = [jnp.asarray(v) for v in values]
    for i in range(2):
        jloss, grads = grad_fn(p, *batch)
        loss = step(*[torch.from_numpy(b) for b in batch])
        close(loss, jloss, MODEL_RTOL)
        if i == 0:
            for name, param in model.named_parameters():
                close(param.grad, grads[names.index(name)], MODEL_RTOL)
        new, state = apply(dict(zip(names, p)), dict(zip(names, grads)),
                           state, i + 1)
        p = [new[n] for n in names]
        got = dict(zip(*export_state(model)))
        for name, want in zip(names, p):
            close(got[name], want, MODEL_RTOL)
    # beam search on the trained weights
    for n, v in zip(names, p):
        jmodel.raw_state_tensors()[n]._value = v
    src, src_len = batch[:2]

    def encode(values, src):
        with jmodel.bind_state(names, values):
            memory, states = jmodel.encode(JaxTensor(src))
        return _raw(memory), [_raw(s) for s in states]

    memory, states = jax.jit(encode)(p, src)
    tile = jnn.BeamSearchDecoder.tile_beam_merge_with_batch
    jmodel.decoder.cell.bind(tile(JaxTensor(memory), 3),
                             tile(JaxTensor(jnp.asarray(src_len)), 3))
    jdec = jnn.BeamSearchDecoder(jmodel.decoder.cell, 1, 2, 3,
                                 embedding_fn=jmodel.tgt_embedder,
                                 output_fn=jmodel.output_layer)
    jids, _ = ref_dynamic_decode(jdec, [JaxTensor(s) for s in states], 5)
    with torch.no_grad():
        ids = model.beam_search(torch.from_numpy(src),
                                torch.from_numpy(src_len), beam_size=3,
                                max_step_num=5)
    np.testing.assert_array_equal(ids.numpy(), jids)


def test_seq2seq_state_names_and_rnn_convert_round_trip(seq2seq_pair):
    """``load_jax_state`` / ``export_state`` carry every new parameter by
    name: the seq2seq's (LSTM, RNN(cell), LSTMCells, Linear), a 2-layer
    bidirectional LSTM's, a BiRNN's, a Bilinear's, a weight-normed
    Linear's."""
    jmodel, model, names, values = seq2seq_pair
    assert export_state(model)[0] == names
    assert "decoder.cell.lstm_cells.1.weight_hh" in names
    assert "encoder.weight_hh_l1" in names
    jbi = jnn.LSTM(IN, HID, num_layers=2, direction="bidirect")
    bi = nn.LSTM(IN, HID, num_layers=2, direction="bidirect", device="cpu")
    seed_weights(jbi, bi, np.random.RandomState(60))
    assert "weight_ih_l1_reverse" in export_state(bi)[0]
    for jl, pl in ((_wrapped(jnn, "birnn"), _wrapped(nn, "birnn",
                                                     device="cpu")),
                   (jnn.Bilinear(3, 4, 5), nn.Bilinear(3, 4, 5,
                                                       device="cpu"))):
        seed_weights(jl, pl, np.random.RandomState(61))
    from paddle_tpu.nn import utils as jutils
    jlin = jutils.weight_norm(jnn.Linear(3, 4))
    lin = nn.utils.weight_norm(nn.Linear(3, 4, generator=torch.Generator(),
                                         device="cpu"))
    seed_weights(jlin, lin, np.random.RandomState(62))
    assert sorted(export_state(lin)[0]) == ["bias", "weight_g", "weight_v"]

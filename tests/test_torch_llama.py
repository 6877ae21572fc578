"""The port's Llama against the JAX package's, on the same weights.

The reference model is built from its own seed; its functional_state()
arrays load into the port through load_jax_state, and both run the same
numpy token ids. float32 tolerance rtol 1e-4 / atol 1e-5 (XLA's CPU
transcendentals are approximate to ~1e-5 relative; sums run in
different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlamaForCausalLM,
    rope_apply as jax_rope_apply,
)
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_jax_state,
    rope_apply,
)

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jcfg = JaxLlamaConfig.tiny(use_parallel=False, num_key_value_heads=2)
    jmodel = JaxLlamaForCausalLM(jcfg)
    names, values = jmodel.functional_state()
    model = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2),
                             device="cpu")
    load_jax_state(model, names, [np.asarray(v) for v in values])
    return jmodel, model, names, [np.asarray(v) for v in values]


def test_full_sequence_logits_match(pair):
    jmodel, model, _, _ = pair
    ids = np.random.RandomState(0).randint(0, 256, (2, 12)).astype(np.int32)
    ref = np.asarray(jmodel(paddle.to_tensor(ids))._value)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long()).numpy()
    assert got.shape == (2, 12, 256)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("offset", [0, 5, [3, 0, 7]])
def test_rope_matches_scalar_and_per_row_offsets(offset):
    rng = np.random.RandomState(1)
    q = rng.randn(3, 4, 2, 16).astype(np.float32)
    k = rng.randn(3, 4, 1, 16).astype(np.float32)
    off = np.asarray(offset, np.int32) if isinstance(offset, list) else offset
    rq, rk = jax_rope_apply.raw_fn(
        jnp.asarray(q), jnp.asarray(k), theta=10000.0,
        position_offset=jnp.asarray(off) if isinstance(offset, list)
        else off)
    tq, tk = rope_apply(
        torch.from_numpy(q), torch.from_numpy(k), 10000.0,
        torch.from_numpy(off) if isinstance(offset, list) else off)
    np.testing.assert_allclose(tq.numpy(), np.asarray(rq), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(rk), **TOL)


def test_load_rejects_wrong_names_and_shapes(pair):
    _, model, names, values = pair
    bad_name = list(names)
    bad_name[0] = bad_name[0] + "_typo"
    with pytest.raises(ValueError, match="unknown names"):
        load_jax_state(model, bad_name, values)
    with pytest.raises(ValueError, match="missing names"):
        load_jax_state(model, names[1:], values[1:])
    i = names.index("lm_head.weight")
    bad_shape = list(values)
    bad_shape[i] = bad_shape[i].T
    with pytest.raises(ValueError, match="lm_head.weight has shape"):
        load_jax_state(model, names, bad_shape)


def test_llama1b_widths_and_device_policy(monkeypatch):
    cfg = LlamaConfig.llama1b()
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.head_dim, cfg.intermediate_size, cfg.vocab_size,
            cfg.max_position_embeddings) == (2048, 22, 16, 128, 5504, 32000,
                                             2048)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig.tiny())

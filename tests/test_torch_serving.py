"""The port's serving engine against the JAX package's, on the same weights.

Both engines serve the same prompts with greedy decoding; their tokens
must be IDENTICAL, request by request, in the three scenarios the
reference pins in tests/test_serving.py: mixed arrival with an early
EOS, slot reuse, and a starved page pool that forces preempt-by-
recompute. The port runs on the CPU here (device="cpu"), which takes
each kernel's plain PyTorch version.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlamaForCausalLM,
)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, \
    load_jax_state
from paddle_tpu_torch.serving import Engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jcfg = JaxLlamaConfig.tiny(use_parallel=False, num_key_value_heads=2)
    jmodel = JaxLlamaForCausalLM(jcfg)
    names, values = jmodel.functional_state()
    model = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2),
                             device="cpu")
    load_jax_state(model, names, [np.asarray(v) for v in values])
    return jmodel, model


def _engines(models, **kw):
    jmodel, model = models
    return (jax_serving.Engine(jmodel, **kw),
            Engine(model, device="cpu", **kw))


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (n,)).tolist() for n in lengths]


def test_mixed_arrival_with_eos(models):
    prompts = _prompts(0, (5, 9, 3, 12, 7))
    probe = Engine(models[1], device="cpu", max_slots=1, num_blocks=64,
                   block_size=4)
    rid = probe.add_request(prompts[1], max_new_tokens=8)
    eos = probe.run()[rid][2]
    outs = []
    for eng in _engines(models, max_slots=2, num_blocks=64, block_size=4):
        ids = [eng.add_request(prompts[0], max_new_tokens=6),
               eng.add_request(prompts[1], max_new_tokens=8,
                               eos_token_id=eos)]
        eng.step()
        eng.step()
        ids += [eng.add_request(prompts[2], max_new_tokens=5),
                eng.add_request(prompts[3], max_new_tokens=4)]
        eng.step()
        ids.append(eng.add_request(prompts[4], max_new_tokens=6))
        while eng.step():
            pass
        outs.append([eng.output(i) for i in ids])
        assert eng.stats()["requests_finished"] == 5
    assert outs[1] == outs[0]
    assert outs[1][1][-1] == eos and len(outs[1][1]) <= 3


def test_slot_reuse(models):
    prompts = _prompts(7, [4 + i for i in range(6)])
    outs = []
    for eng in _engines(models, max_slots=2, num_blocks=64, block_size=4):
        ids = [eng.add_request(p, max_new_tokens=4) for p in prompts]
        res = eng.run()
        outs.append([res[i] for i in ids])
    assert outs[1] == outs[0]
    assert all(len(o) == 4 for o in outs[1])


def test_starved_pool_preempts_and_matches(models):
    prompts = _prompts(1, (6, 8))
    outs = []
    for eng in _engines(models, max_slots=2, num_blocks=7, block_size=4):
        ids = [eng.add_request(p, max_new_tokens=10) for p in prompts]
        res = eng.run()
        outs.append([res[i] for i in ids])
        assert eng.stats()["preemptions"] >= 1
    assert outs[1] == outs[0]
    roomy = Engine(models[1], device="cpu", max_slots=2, num_blocks=64,
                   block_size=4)
    ids = [roomy.add_request(p, max_new_tokens=10) for p in prompts]
    res = roomy.run()
    assert [res[i] for i in ids] == outs[1]
    assert roomy.stats()["preemptions"] == 0


def test_admission_validation_and_zero_length(models):
    eng = Engine(models[1], device="cpu", max_slots=2, num_blocks=5,
                 block_size=4, max_model_len=32)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.add_request([], max_new_tokens=2)
    with pytest.raises(ValueError, match="exceeds max_model_len"):
        eng.add_request([1] * 30, max_new_tokens=3)
    with pytest.raises(ValueError, match="usable blocks"):
        eng.add_request([1] * 14, max_new_tokens=3)
    rid = eng.add_request([1, 2, 3], max_new_tokens=0)
    assert not eng.has_work() and eng.run() == {rid: []}
    assert eng.stats()["requests_finished"] == 1
    assert eng.cache.allocator.free_blocks == 4
    # the prefill bucket never pads past the block table's capacity
    assert eng._bucket(17) <= eng.cache.max_blocks_per_slot * 4


def test_engine_without_device_raises_without_cuda(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(models[1])


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import pkgutil, sys, importlib\n"
        "import paddle_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                               'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'paddle_tpu' or m.startswith('paddle_tpu.')]\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules\n"
        "               if m.startswith('paddle_tpu_torch')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    imported = set(res.stdout.split())
    assert len(imported) >= 30
    assert {"paddle_tpu_torch.nn.functional.loss",
            "paddle_tpu_torch.optimizer.optimizers",
            "paddle_tpu_torch.parallel.engine",
            "paddle_tpu_torch.tools.train_profile",
            "paddle_tpu_torch.kernels.fused_ce",
            "paddle_tpu_torch.core.flags",
            "paddle_tpu_torch.optimizer.clip",
            "paddle_tpu_torch.optimizer.lr",
            "paddle_tpu_torch.tools.mma_probe",
            "paddle_tpu_torch.serving.prefix_cache",
            "paddle_tpu_torch.kernels.quant",
            "paddle_tpu_torch.serving.kv_cache",
            "paddle_tpu_torch.serving.kernels.paged_attention",
            "paddle_tpu_torch.nn.functional.conv",
            "paddle_tpu_torch.nn.functional.pooling",
            "paddle_tpu_torch.nn.layers.conv",
            "paddle_tpu_torch.nn.layers.pooling",
            "paddle_tpu_torch.nn.layers.loss",
            "paddle_tpu_torch.regularizer",
            "paddle_tpu_torch.vision.models.resnet",
            "paddle_tpu_torch.tools.model_benchmark",
            "paddle_tpu_torch.ops.manipulation",
            "paddle_tpu_torch.nn.functional.common",
            "paddle_tpu_torch.nn.layers.common",
            "paddle_tpu_torch.nn.layers.rnn",
            "paddle_tpu_torch.nn.decode",
            "paddle_tpu_torch.nn.initializer",
            "paddle_tpu_torch.nn.utils"} <= imported

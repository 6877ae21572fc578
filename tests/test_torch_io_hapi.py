"""The port's training front end (``framework.io``, ``io``, ``metric``,
``hapi``) against the JAX package's, on the same numbers.

``save`` / ``load`` round trips are held bit for bit; a file the
reference wrote loads in the port without importing the reference (a
subprocess shows it). ``DataLoader`` batches from the same numpy seed
equal the reference's, with 0 and 2 worker processes (values equal; the
port's integer labels are int64 where the reference's JAX arrays are
int32). The metrics and ``flops`` are integers or host float64 sums, held
exactly or to float64 rounding. ``Model.fit`` / ``evaluate`` / ``predict``
run a tiny MLP eagerly in both packages on weights carried across: the
histories' float32 losses within rtol 1e-5 (sums in another order, two
Adam steps an epoch), accuracies exactly.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.hapi as jhapi
import paddle_tpu.io as jio
import paddle_tpu.metric as jmetric
import paddle_tpu.nn as jnn
import paddle_tpu.vision.models as jmodels
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.optimizer import Adam as JaxAdam
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp, hapi, io, metric, nn
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.optimizer import Adam, AdamW, lr
from paddle_tpu_torch.vision import models
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIST_RTOL = 1e-5


# -- save / load ---------------------------------------------------------------

def _equal_trees(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert a.shape == b.shape

        def bits(t):   # floats as their bytes: NaN, -0.0 and inf count
            t = t.detach().contiguous().reshape(-1)
            return t.view(torch.uint8) if t.is_floating_point() and \
                t.numel() else t
        assert torch.equal(bits(a), bits(b))
        return
    # a state dict (an OrderedDict) comes back a dict, as the reference's
    kind = dict if isinstance(a, dict) else type(a)
    assert isinstance(a, kind) and isinstance(b, kind), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert a == b


def test_save_load_round_trips_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    weird = torch.tensor([0.0, -0.0, float("inf"), float("nan"), 1e-40])
    obj = {"f32": torch.randn(3, 4, generator=g),
           "bf16": torch.randn(5, generator=g).bfloat16(),
           "f16": torch.cat([torch.randn(4, generator=g), weird]).half(),
           "nested": {"ids": torch.arange(6).reshape(2, 3),
                      "list": [torch.ones(2, dtype=torch.bool), 3, "x"],
                      "tuple": (1.5, torch.zeros(0))},
           "edge": weird}
    path = str(tmp_path / "sub" / "obj.pd")
    pt.save(obj, path)
    _equal_trees(pt.load(path, device="cpu"), obj)
    raw = pt.load(path, return_numpy=True)
    assert raw["bf16"].dtype == np.uint16   # its bits, as the reference
    assert raw["f16"].dtype == np.float16
    with pytest.raises(NotImplementedError, match="17"):
        pt.save(obj, path, use_binary_format=True)
    with pytest.raises(NotImplementedError, match="17"):
        pt.load(path, keep_name_table=True)


def test_optimizer_model_and_scaler_state_round_trip(tmp_path):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    model = LlamaForCausalLM(LlamaConfig.tiny(dtype="bfloat16"),
                             device="cpu")
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=10),
                            warmup_steps=2, start_lr=1e-4, end_lr=1e-3)
    opt = AdamW(learning_rate=sched, parameters=model.parameters())
    scaler = amp.GradScaler(init_loss_scaling=8.0)
    ids = torch.arange(24).reshape(2, 12)
    for _ in range(2):
        scaler.scale(model(ids, ids)).backward()
        scaler.step(opt)
        opt.clear_grad()
        sched.step()
    state = {"model": model.state_dict(), "opt": opt.state_dict(),
             "scaler": scaler.state_dict()}
    pt.save(state, str(tmp_path / "ckpt.pd"))
    back = pt.load(str(tmp_path / "ckpt.pd"), device="cpu")
    _equal_trees(back, state)
    fresh = LlamaForCausalLM(LlamaConfig.tiny(dtype="bfloat16"),
                             device="cpu", generator=torch.Generator()
                             .manual_seed(1))
    fresh.load_state_dict(back["model"])
    sched2 = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=10),
                             warmup_steps=2, start_lr=1e-4, end_lr=1e-3)
    opt2 = AdamW(learning_rate=sched2, parameters=fresh.parameters())
    opt2.set_state_dict(back["opt"])
    assert opt2.get_lr() == opt.get_lr()
    _equal_trees(opt2.state_dict(), opt.state_dict())


def test_a_reference_file_loads_without_the_reference(tmp_path):
    path = str(tmp_path / "ref.pdparams")
    rng = np.random.RandomState(0)
    f32 = rng.randn(3, 2).astype(np.float32)
    bf = rng.randn(4).astype(np.float32)
    paddle.save({"w": JaxTensor(jnp.asarray(f32)),
                 "b": JaxTensor(jnp.asarray(bf, jnp.bfloat16)),
                 "meta": {"step": 7, "ids": JaxTensor(jnp.arange(3))}},
                path)
    code = ("import sys, json\n"
            "from paddle_tpu_torch.framework.io import load\n"
            "r = load(sys.argv[1], device='cpu')\n"
            "assert not [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu']\n"
            "print(json.dumps({k: str(v.dtype) if hasattr(v, 'dtype') "
            "else v['step'] for k, v in r.items()}))\n")
    res = subprocess.run([sys.executable, "-c", code, path], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == {"w": "torch.float32",
                                      "b": "torch.bfloat16", "meta": 7}
    got = pt.load(path, device="cpu")
    np.testing.assert_array_equal(got["w"].numpy(), f32)
    # bit for bit: the bf16 value of each float (the reference's own load
    # reads the uint16 bits as numbers, "Faults of the reference" 16)
    np.testing.assert_array_equal(
        got["b"].float().numpy(),
        np.asarray(jnp.asarray(bf, jnp.bfloat16), np.float32))
    assert got["meta"]["ids"].tolist() == [0, 1, 2]


# -- io ------------------------------------------------------------------------

class _NumpyItems:
    """Items of numpy arrays and numbers (float64 on purpose)."""

    def __len__(self):
        return 23

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        return rng.randn(3, 2), np.int64(i % 5), {"w": float(i) / 3}


class PortItems(_NumpyItems, io.Dataset):
    pass


class RefItems(_NumpyItems, jio.Dataset):
    pass


class PortBroken(PortItems):
    def __getitem__(self, i):
        if i == 13:
            raise KeyError("item 13")
        return super().__getitem__(i)


def _np_tree(batch):
    if isinstance(batch, dict):
        return {k: _np_tree(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [_np_tree(b) for b in batch]
    v = getattr(batch, "_value", batch)
    return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np_tree(g), _np_tree(w)
        assert len(g) == len(w) == 3
        np.testing.assert_array_equal(g[0], w[0])
        assert g[0].dtype == w[0].dtype == np.float32
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2]["w"], w[2]["w"])


@pytest.mark.parametrize("workers", [0, 2])
def test_data_loader_batches_equal_the_references(workers):
    batches = {}
    for side, ds, loader in (("ref", RefItems(), jio.DataLoader),
                             ("port", PortItems(), io.DataLoader)):
        np.random.seed(11)
        kw = {"device": "cpu"} if side == "port" else {}
        batches[side] = list(loader(ds, batch_size=4, shuffle=True,
                                    drop_last=False, num_workers=workers,
                                    **kw))
    _same_batches(batches["port"], batches["ref"])
    assert len(batches["port"]) == 6


def test_data_loader_workers_surface_errors_and_init():
    with pytest.raises(RuntimeError, match="KeyError.*item 13"):
        list(io.DataLoader(PortBroken(), batch_size=4, num_workers=2,
                           device="cpu"))
    seen = []

    class WhoAmI(io.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            info = io.get_worker_info()
            return np.array([info.id, info.num_workers, os.getpid()])

    got = list(io.DataLoader(WhoAmI(), batch_size=1, num_workers=2,
                             device="cpu", worker_init_fn=seen.append))
    ids = [int(b[0, 0]) for b in got]
    assert ids == [0, 1, 0, 1] and all(int(b[0, 1]) == 2 for b in got)
    assert all(int(b[0, 2]) != os.getpid() for b in got)
    assert seen == [] and io.get_worker_info() is None


def test_data_loader_timeout_and_threaded_paths():
    class Slow(io.Dataset):
        def __len__(self):
            return 2

        def __getitem__(self, i):
            import time
            time.sleep(5)
            return np.zeros(1)

    with pytest.raises(RuntimeError, match="timed out"):
        list(io.DataLoader(Slow(), num_workers=1, timeout=1, device="cpu"))

    class Stream(io.IterableDataset):
        def __iter__(self):
            return iter(np.arange(7.0))

    got = list(io.DataLoader(Stream(), batch_size=3, num_workers=2,
                             device="cpu"))
    assert [b.tolist() for b in got] == [[0, 1, 2], [3, 4, 5], [6]]
    got = list(io.DataLoader(PortItems(), batch_size=10, num_workers=2,
                             use_shared_memory=False, device="cpu",
                             pin_memory=True))
    assert [len(b[1]) for b in got] == [10, 10, 3]


def test_samplers_equal_the_references():
    ds = list(range(10))
    for make, jmake in (
            (lambda: io.RandomSampler(ds), lambda: jio.RandomSampler(ds)),
            (lambda: io.RandomSampler(ds, replacement=True, num_samples=7),
             lambda: jio.RandomSampler(ds, replacement=True,
                                       num_samples=7)),
            (lambda: io.WeightedRandomSampler(np.arange(1, 11), 6),
             lambda: jio.WeightedRandomSampler(np.arange(1, 11), 6))):
        np.random.seed(3)
        want = list(jmake())
        np.random.seed(3)
        assert list(make()) == want
    for kw in (dict(num_replicas=3, rank=1, shuffle=True),
               dict(num_replicas=2, rank=0, drop_last=True)):
        s, js = (cls(ds, 3, **kw) for cls in (io.DistributedBatchSampler,
                                              jio.DistributedBatchSampler))
        s.set_epoch(4)
        js.set_epoch(4)
        assert list(s) == list(js) and len(s) == len(js)
    assert list(io.DistributedBatchSampler(ds, 4)) == [[0, 1, 2, 3],
                                                       [4, 5, 6, 7], [8, 9]]
    np.random.seed(5)
    a, b = jio.random_split(jio.TensorDataset([np.arange(10)]), [6, 4])
    np.random.seed(5)
    c, d = io.random_split(io.TensorDataset([torch.arange(10)]), [6, 4])
    assert c.indices == a.indices and d.indices == b.indices
    both = io.ComposeDataset([io.TensorDataset([torch.arange(3)]),
                              io.TensorDataset([torch.arange(3) * 2])])
    assert [tuple(int(v) for v in both[i]) for i in range(3)] == [
        (0, 0), (1, 2), (2, 4)]
    chain = io.ChainDataset([range(2), range(3)])
    assert [x for x in chain] == [0, 1, 0, 1, 2]


@pytest.mark.parametrize("make", [
    lambda: io.RandomSampler([1], generator=torch.Generator()),
    lambda: io.DataLoader([1], places="cpu", device="cpu"),
    lambda: io.DataLoader([1], return_list=False, device="cpu"),
    lambda: io.DataLoader([1], use_buffer_reader=False, device="cpu"),
    lambda: io.DataLoader([1], persistent_workers=True, device="cpu"),
    lambda: io.DataLoader([1], feed_list=[1], device="cpu"),
])
def test_io_refuses_the_arguments_the_reference_ignores(make):
    with pytest.raises(NotImplementedError, match="18"):
        make()


# -- metric --------------------------------------------------------------------

def test_metrics_equal_the_references():
    rng = np.random.RandomState(8)
    for _ in range(3):
        pred = rng.rand(16, 6).astype(np.float32)
        label = rng.randint(0, 6, (16, 1))
        acc, jacc = metric.Accuracy(topk=(1, 3)), jmetric.Accuracy(
            topk=(1, 3))
        for m, pr, lb in ((acc, torch.from_numpy(pred).bfloat16().float(),
                           torch.from_numpy(label)),
                          (jacc, JaxTensor(jnp.asarray(pred, jnp.bfloat16)
                                           .astype(jnp.float32)),
                           JaxTensor(jnp.asarray(label)))):
            m.update(m.compute(pr, lb))
        assert acc.accumulate() == jacc.accumulate()
        assert acc.name() == jacc.name() == "acc"
        probs = rng.rand(40).astype(np.float32)
        labels = rng.randint(0, 2, 40)
        for cls in ("Precision", "Recall", "Auc"):
            m, jm = getattr(metric, cls)(), getattr(jmetric, cls)()
            m.update(torch.from_numpy(probs), torch.from_numpy(labels))
            jm.update(JaxTensor(jnp.asarray(probs)),
                      JaxTensor(jnp.asarray(labels)))
            assert m.accumulate() == jm.accumulate(), cls
        got = metric.accuracy(torch.from_numpy(pred),
                              torch.from_numpy(label), k=2)
        want = jmetric.accuracy(JaxTensor(jnp.asarray(pred)),
                                JaxTensor(jnp.asarray(label)), k=2)
        assert got.item() == float(want._value)
    with pytest.raises(NotImplementedError, match="20"):
        metric.Auc(curve="PR")


# -- hapi: Model, callbacks, flops, summary ------------------------------------

def _mlps():
    """The same MLP in both packages (8 -> 16 -> 4), reference weights
    carried into the port's."""
    paddle.seed(0)
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    gen = torch.Generator().manual_seed(0)
    net = nn.Sequential(nn.Linear(8, 16, generator=gen, device="cpu"),
                        nn.ReLU(),
                        nn.Linear(16, 4, generator=gen, device="cpu"))
    names, values = jnet.functional_state()
    load_jax_state(net, names, [np.asarray(v) for v in values])
    return jnet, net


class _Pairs:
    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        self.x = rng.randn(n, 8).astype(np.float32)
        self.y = rng.randint(0, 4, (n,)).astype(np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


class PortPairs(_Pairs, io.Dataset):
    pass


class RefPairs(_Pairs, jio.Dataset):
    pass


def _fit_both(tmp_path, callbacks, epochs=3):
    jnet, net = _mlps()
    runs = {}
    for side, Model, DS, opt, loss, acc, cb in (
            ("ref", jhapi.Model, RefPairs,
             JaxAdam(learning_rate=0.05, parameters=jnet.parameters()),
             jnn.CrossEntropyLoss(), jmetric.Accuracy(topk=(1, 2)),
             callbacks(jhapi, tmp_path / "ref")),
            ("port", hapi.Model, PortPairs,
             Adam(learning_rate=0.05, parameters=net.parameters()),
             nn.CrossEntropyLoss(), metric.Accuracy(topk=(1, 2)),
             callbacks(hapi, tmp_path / "port"))):
        model = Model(jnet if side == "ref" else net)
        model.prepare(opt, loss, acc)
        np.random.seed(2)
        hist = model.fit(DS(16, 0), eval_data=DS(8, 1), batch_size=8,
                         epochs=epochs, verbose=0, callbacks=cb)
        runs[side] = (model, hist)
    return runs


def _close_logs(got, want):
    assert list(got) == list(want)
    for k in got:
        if k == "loss":
            np.testing.assert_allclose(got[k], want[k], rtol=HIST_RTOL)
        else:
            assert got[k] == want[k], k


def test_model_fit_evaluate_predict_equal_the_references(tmp_path):
    runs = _fit_both(tmp_path, lambda h, d: [h.ModelCheckpoint(
        save_freq=2, save_dir=str(d))])
    (jmodel, jhist), (model, hist) = runs["ref"], runs["port"]
    assert len(hist) == len(jhist) == 3
    for got, want in zip(hist, jhist):
        _close_logs(got, want)
    _close_logs(model.evaluate(PortPairs(8, 3), batch_size=4, verbose=0),
                jmodel.evaluate(RefPairs(8, 3), batch_size=4, verbose=0))
    got = model.predict(PortPairs(6, 4), batch_size=4, stack_outputs=True)
    want = jmodel.predict(RefPairs(6, 4), batch_size=4, stack_outputs=True)
    # six Adam steps move each weight by ~lr whatever its gradient's size,
    # so the rounding gap grows a little a step: 1e-4 of the largest output
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=1e-4 * float(np.abs(want[0]).max()))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref")) == [
        "0.pdopt", "0.pdparams", "2.pdopt", "2.pdparams", "final.pdopt",
        "final.pdparams"]
    # the reference's checkpoint loads into a fresh port model
    _, fresh = _mlps()
    other = hapi.Model(fresh).prepare(
        Adam(learning_rate=0.05, parameters=fresh.parameters()))
    other.load(str(tmp_path / "ref" / "final"))
    for (n, p), q in zip(fresh.named_parameters(), model.parameters()):
        q = q.detach().numpy()
        np.testing.assert_allclose(p.detach().numpy(), q, rtol=0,
                                   atol=1e-4 * float(np.abs(q).max()),
                                   err_msg=n)
    assert other._optimizer.state_dict()["global_step"] == 6
    # the port's own save / load: bit for bit
    model.save(str(tmp_path / "mine"))
    _, again = _mlps()
    hapi.Model(again).load(str(tmp_path / "mine"))
    for p, q in zip(again.parameters(), model.parameters()):
        assert torch.equal(p, q)


def test_early_stopping_equals_the_references(tmp_path):
    runs = _fit_both(tmp_path, lambda h, d: [h.EarlyStopping(
        monitor="acc", mode="max", patience=1, min_delta=0.5)], epochs=5)
    (jmodel, jhist), (model, hist) = runs["ref"], runs["port"]
    assert len(hist) == len(jhist) < 5
    assert model.stop_training and jmodel.stop_training
    for got, want in zip(hist, jhist):
        _close_logs(got, want)


@pytest.mark.parametrize("make", [
    lambda: hapi.Model(torch.nn.Linear(2, 2), inputs=[1]),
    lambda: hapi.Model(torch.nn.Linear(2, 2)).prepare(amp_configs={}),
    lambda: hapi.Model(torch.nn.Linear(2, 2)).load("x", skip_mismatch=True),
    lambda: hapi.Model(torch.nn.Linear(2, 2)).predict([], verbose=1),
    lambda: hapi.Model(torch.nn.Linear(2, 2)).summary((1, 2)),
])
def test_model_refuses_the_arguments_the_reference_ignores(make):
    with pytest.raises(NotImplementedError, match="19"):
        make()


@pytest.mark.parametrize("kwargs", [dict(baseline=0.5),
                                    dict(save_best_model=False)])
def test_early_stopping_refuses_what_the_reference_ignores(kwargs):
    with pytest.raises(NotImplementedError, match="20"):
        hapi.EarlyStopping(**kwargs)


def _zero_create(self, shape, dtype=None, name=None):
    return JaxParameter(np.zeros(tuple(int(s) for s in shape), np.float32),
                        name=name)


def test_flops_and_summary_equal_the_references(capsys):
    jnet, net = _mlps()
    assert pt.flops(net, [2, 8]) == jhapi.flops(jnet, [2, 8])
    assert pt.summary(net) == paddle.summary(jnet, None)
    saved = jinit.Initializer.create
    jinit.Initializer.create = _zero_create
    try:
        jres = jmodels.resnet18(num_classes=10)
    finally:
        jinit.Initializer.create = saved
    res = models.resnet18(num_classes=10, device="cpu")
    want = jhapi.flops(jres, [1, 3, 32, 32])
    assert pt.flops(res, [1, 3, 32, 32], print_detail=True) == want
    assert "Total FLOPs: %d" % want in capsys.readouterr().out
    assert pt.Model is hapi.Model and pt.callbacks.ModelCheckpoint is \
        hapi.ModelCheckpoint

"""Training callbacks for ``hapi.Model`` (counterpart of
paddle_tpu/hapi/callbacks.py): ``Callback``, ``CallbackList``,
``ProgBarLogger``, ``ModelCheckpoint``, ``LRScheduler``, ``EarlyStopping``
and ``config_callbacks``.

``LRScheduler`` steps the optimizer's learning-rate scheduler (the port's
optimizers keep it as ``_lr_scheduler``). ``EarlyStopping`` takes
``baseline`` and ``save_best_model`` at their defaults only: the reference
accepts both and applies neither, so it never saves a best model ("Faults
of the reference" 20 in ROADMAP.md).
"""
from __future__ import annotations

import os
import sys
import time


class Callback:
    """Base callback (reference callbacks.py Callback)."""

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)

        return call


class ProgBarLogger(Callback):
    """Per-epoch progress logging (reference ProgBarLogger)."""

    def __init__(self, log_freq=10, verbose=1):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = (self.params or {}).get("steps")
        self._t0 = time.monotonic()
        if self.verbose:
            print("Epoch %d/%d" % (epoch + 1,
                                   (self.params or {}).get("epochs", 1)))

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = ", ".join(
                "%s: %.4f" % (k, float(v)) for k, v in (logs or {}).items()
                if not hasattr(v, "__len__"))
            total = "/%s" % self.steps if self.steps else ""
            print("  step %d%s - %s" % (step, total, items))
            sys.stdout.flush()

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            items = ", ".join(
                "%s: %.4f" % (k, float(v)) for k, v in (logs or {}).items()
                if not hasattr(v, "__len__"))
            print("  epoch %d done in %.1fs - %s"
                  % (epoch + 1, time.monotonic() - self._t0, items))

    def on_eval_end(self, logs=None):
        if self.verbose:
            items = ", ".join(
                "%s: %.4f" % (k, float(v)) for k, v in (logs or {}).items()
                if not hasattr(v, "__len__"))
            print("  eval - %s" % items)


class ModelCheckpoint(Callback):
    """Save model+optimizer every save_freq epochs (reference
    ModelCheckpoint)."""

    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir or "checkpoint"

    def on_epoch_end(self, epoch, logs=None):
        if epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, "%d" % epoch)
            self.model.save(path)

    def on_train_end(self, logs=None):
        self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Step the optimizer's LRScheduler (reference hapi LRScheduler cb)."""

    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        return getattr(self.model._optimizer, "_lr_scheduler", None)

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class EarlyStopping(Callback):
    """Stop when a monitored metric stops improving (reference
    EarlyStopping)."""

    def __init__(self, monitor="loss", mode="auto", patience=0,
                 min_delta=0, baseline=None, save_best_model=True):
        for name, value, default in (("baseline", baseline, None),
                                     ("save_best_model", save_best_model,
                                      True)):
            if value is not default:
                raise NotImplementedError(
                    "EarlyStopping(%s=%r): the reference accepts it and "
                    "never applies it (\"Faults of the reference\" 20 in "
                    "ROADMAP.md)" % (name, value))
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode
        self.wait = 0
        self.best = None
        self.stopped_epoch = None

    def _better(self, cur, best):
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(cur if not hasattr(cur, "__len__") else cur[0])
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                self.stopped_epoch = True


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     verbose=1, log_freq=10, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({
        "epochs": epochs, "steps": steps, "verbose": verbose,
        "metrics": metrics or [],
    })
    return lst

"""Estimator: a Keras-style train and evaluate facade over Gluon.

Counterpart of ``mxnet_tpu/gluon/contrib/estimator/estimator.py`` (MXNet
1.x ``estimator.py:42``; ``fit`` :326, ``evaluate`` :272, the handler
dispatch :423). ``fit`` drains on a preemption request
(:mod:`mxnet_tpu_torch.preempt`): the batch in flight finishes, every
:class:`CheckpointHandler` writes a mid-epoch checkpoint, and the process
exits with the reschedule code (75).

``context=None`` is the card, ``gpu(0)``, as everywhere in the port;
without one it raises. The JAX package falls back to the CPU when it
finds no accelerator; here the CPU runs only when asked for
(``context=mx.cpu()``).
"""
from __future__ import annotations

import logging

from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            LoggingHandler, StoppingHandler, TrainBegin,
                            TrainEnd)

__all__ = ["Estimator"]


class Estimator:
    """Trains ``net`` on ``loss`` with ``trainer`` (default
    ``gluon.Trainer(..., "adam", {"learning_rate": 1e-3})``) on
    ``context`` (default the card)."""

    def __init__(self, net, loss, train_metrics=None, val_metrics=None,
                 initializer=None, trainer=None, context=None,
                 val_net=None, val_loss=None):
        from .... import metric as metric_mod
        from ....base import MXNetError
        from ....context import gpu, num_gpus
        from ...trainer import Trainer

        self.net = net
        self.loss = loss
        self.val_net = val_net or net
        self.val_loss = val_loss or loss
        self.logger = logging.getLogger("Estimator")
        self.logger.setLevel(logging.INFO)
        if context is None:
            if num_gpus() == 0:
                raise MXNetError(
                    "Estimator(context=None) trains on the card, gpu(0), "
                    "and no CUDA card is visible; pass context=mx.cpu() "
                    "to train on the CPU")
            context = gpu(0)
        self.context = context if isinstance(context, (list, tuple)) \
            else [context]
        self.train_metrics = [metric_mod.create(m)
                              for m in (train_metrics or ["accuracy"])]
        self.val_metrics = [metric_mod.create(m)
                            for m in (val_metrics or ["accuracy"])]
        self.train_loss_metric = metric_mod.Loss("train_loss")
        self.val_loss_metric = metric_mod.Loss("val_loss")
        if initializer is not None or not self._is_initialized():
            from .... import initializer as init_mod

            self.net.initialize(initializer or init_mod.Xavier(),
                                ctx=self.context[0], force_reinit=False)
        self.trainer = trainer or Trainer(
            self.net.collect_params(), "adam", {"learning_rate": 1e-3})
        self.stop_training = False

    def _is_initialized(self):
        for p in self.net.collect_params().values():
            try:
                p.data()
            except Exception:
                return False
        return True

    def _get_data_and_label(self, batch):
        ctx = self.context[0]
        if hasattr(batch, "data"):  # DataBatch
            return batch.data[0].as_in_context(ctx), \
                batch.label[0].as_in_context(ctx)
        data, label = batch
        return data.as_in_context(ctx), label.as_in_context(ctx)

    def evaluate_batch(self, batch):
        data, label = self._get_data_and_label(batch)
        pred = self.val_net(data)
        loss = self.val_loss(pred, label)
        self.val_loss_metric.update(None, [loss])
        for metric in self.val_metrics:
            metric.update([label], [pred])

    def evaluate(self, val_data, batch_axis=0, event_handlers=None):
        """Every validation metric over ``val_data``: ``{name: value}``."""
        for metric in self.val_metrics + [self.val_loss_metric]:
            metric.reset()
        for batch in val_data:
            self.evaluate_batch(batch)
        if hasattr(val_data, "reset"):
            val_data.reset()
        return {m.get()[0]: m.get()[1]
                for m in self.val_metrics + [self.val_loss_metric]}

    def fit_batch(self, batch):
        from .... import autograd

        data, label = self._get_data_and_label(batch)
        with autograd.record():
            pred = self.net(data)
            loss = self.loss(pred, label)
        loss.backward()
        self.trainer.step(data.shape[0])
        self.train_loss_metric.update(None, [loss])
        for metric in self.train_metrics:
            metric.update([label], [pred])
        return data, label, pred, loss

    def fit(self, train_data, val_data=None, epochs=None,
            event_handlers=None, batches=None, batch_axis=0):
        """Train for ``epochs`` (or ``batches``), dispatching the event
        handlers. ``MXNET_TPU_PREEMPT`` installs the drain handlers; a
        requested drain ends the run after the batch in flight
        (:meth:`_drain`)."""
        from .... import preempt as _preempt

        _preempt.maybe_install_from_env()
        if epochs is None and batches is None:
            epochs = 1
        handlers = self._prepare_handlers(epochs, batches, event_handlers)
        self.stop_training = False
        for h in handlers:
            if isinstance(h, TrainBegin):
                h.train_begin(self)
        while not self.stop_training:
            for metric in self.train_metrics + [self.train_loss_metric]:
                metric.reset()
            for h in handlers:
                if isinstance(h, EpochBegin):
                    h.epoch_begin(self)
            for batch in train_data:
                for h in handlers:
                    if isinstance(h, BatchBegin):
                        h.batch_begin(self, batch=batch)
                data, label, pred, loss = self.fit_batch(batch)
                for h in handlers:
                    if isinstance(h, BatchEnd):
                        h.batch_end(self, batch=batch,
                                    batch_size=data.shape[0])
                # kept into the next batch, the outputs would keep their
                # autograd graph alive while a hybridized net's training
                # pair captures its own
                del data, label, pred, loss
                if _preempt.requested():
                    self._drain(handlers, _preempt)
                if self.stop_training:
                    break
            if hasattr(train_data, "reset"):
                train_data.reset()
            if val_data is not None:
                self.evaluate(val_data)
            for h in handlers:
                if isinstance(h, EpochEnd):
                    h.epoch_end(self)
        for h in handlers:
            if isinstance(h, TrainEnd):
                h.train_end(self)

    def _drain(self, handlers, _preempt):
        """The drain: a mid-epoch checkpoint through every handler that
        has ``drain_save``, then ``preempt.drain`` (``SystemExit`` with
        the reschedule code)."""
        self.logger.warning(
            "preemption drain requested (%s): writing final checkpoint "
            "and exiting for reschedule",
            (_preempt.event() or {}).get("signal") or "api")
        saved = False
        for h in handlers:
            if hasattr(h, "drain_save"):
                h.drain_save(self)
                saved = True
        # the handlers checkpointed: skip the last-resort hook
        _preempt.drain(save=False if saved else None)

    def _prepare_handlers(self, epochs, batches, event_handlers):
        handlers = list(event_handlers or [])
        if not any(isinstance(h, StoppingHandler) for h in handlers):
            handlers.append(StoppingHandler(max_epoch=epochs,
                                            max_batch=batches))
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler(
                metrics=self.train_metrics + [self.train_loss_metric]))
        return handlers

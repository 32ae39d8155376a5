"""BaseModule: the high-level train, score and predict loops.

Counterpart of ``mxnet_tpu/module/base_module.py`` (MXNet 1.x
``python/mxnet/module/base_module.py``): ``fit`` (the epoch and batch
loop with the metric, the monitor, the callbacks and the epoch-end
checkpoint), ``score``, ``predict``, ``forward_backward``,
``set_params`` and ``BatchEndParam``. A concrete module implements the
intermediate API (``bind``, ``init_params``, ``init_optimizer``,
``forward``, ``backward``, ``update``, ``update_metric``, ...).

``fit`` drains on a preemption request (:mod:`mxnet_tpu_torch.preempt`,
JAX :148-205): the batch in flight finishes, the ``epoch_end_callback``
chain runs once for the partial epoch (where ``callback.do_checkpoint``
saves), and the process exits with the reschedule code (75).
"""
from __future__ import annotations

import logging
import time
from collections import namedtuple

import torch

from .. import metric as metric_mod
from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["BaseModule", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParam",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, (list, tuple)) else [obj]


class BaseModule:
    """The loops over a module's intermediate API."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # ------------------------------------------------------ to implement --
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError

    def install_monitor(self, mon):
        raise NotImplementedError

    @property
    def symbol(self):
        return self._symbol

    # -------------------------------------------------------- composites --
    def forward_backward(self, data_batch):
        """A training forward and its backward."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """``eval_metric`` over ``eval_data`` (inference forwards);
        returns its ``get_name_value()``."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("score needs a bound module with parameters")
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        nbatch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            for cb in _as_list(batch_end_callback):
                cb(BatchEndParam(epoch, nbatch, eval_metric, locals()))
        for cb in _as_list(score_end_callback):
            cb(BatchEndParam(epoch, nbatch, eval_metric, locals()))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, sparse_row_id_fn=None):
        """The outputs over ``eval_data`` (padding rows dropped), merged
        along the batch axis unless ``merge_batches`` is false."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("predict needs a bound module with parameters")
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = getattr(eval_batch, "pad", 0) or 0
            output_list.append([NDArray(o._data[:o.shape[0] - pad].clone())
                                for o in self.get_outputs()])
        if not output_list:
            return []
        if not merge_batches:
            return output_list
        num_outputs = len(output_list[0])
        if any(len(outs) != num_outputs for outs in output_list):
            raise MXNetError("Cannot merge batches: different number of "
                             "outputs")
        merged = [NDArray(torch.cat([o[i]._data for o in output_list]))
                  for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """MXNet 1.x's training loop: bind, install the monitor, init the
        parameters (``Uniform(0.01)`` unless ``initializer``) and the
        optimizer, then per batch ``forward_backward``, ``update``,
        ``update_metric`` and the batch-end callbacks, and per epoch the
        metric's log, the epoch-end callbacks (checkpoints) and the
        validation score. ``MXNET_TPU_PREEMPT`` installs the drain
        handlers; a requested drain ends the loop after the batch in
        flight (the module's docstring)."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        from .. import initializer as init_mod
        from .. import preempt as _preempt

        _preempt.maybe_install_from_env()

        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            train_data.reset()
            for data_batch in train_data:
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                for cb in _as_list(batch_end_callback):
                    cb(BatchEndParam(epoch, nbatch, eval_metric, locals()))
                nbatch += 1
                if _preempt.requested():
                    self.logger.warning(
                        "Epoch[%d] Batch[%d]: preemption drain requested; "
                        "checkpointing and exiting for reschedule",
                        epoch, nbatch)
                    arg_p, aux_p = self.get_params()
                    for cb in _as_list(epoch_end_callback):
                        cb(epoch, self.symbol, arg_p, aux_p)
                    # the callbacks checkpointed: record and exit only
                    _preempt.drain(save=False)

            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            arg_p, aux_p = self.get_params()
            self.set_params(arg_p, aux_p)
            for cb in _as_list(epoch_end_callback):
                cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        """Write parameter values (``init_params`` with no
        initializer)."""
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    # ------------------------------------------------------------- misc ---
    @property
    def data_names(self):
        raise NotImplementedError

    @property
    def output_names(self):
        raise NotImplementedError

    @property
    def data_shapes(self):
        raise NotImplementedError

    @property
    def label_shapes(self):
        raise NotImplementedError

    @property
    def output_shapes(self):
        raise NotImplementedError

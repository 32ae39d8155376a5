"""BucketingModule: variable-length inputs through one Module per bucket.

Counterpart of ``mxnet_tpu/module/bucketing_module.py`` (MXNet 1.x
``python/mxnet/module/bucketing_module.py``). ``sym_gen(bucket_key)``
returns ``(symbol, data_names, label_names)``; ``bind`` binds the
default bucket's Module, and a batch of another ``bucket_key`` binds
that bucket's Module on first sight with ``shared_module`` set to the
default one (``switch_bucket``): every bucket computes in the same
parameter, gradient and auxiliary arrays.

Where the JAX package and MXNet 1.x differ, the port follows MXNet 1.x:
one optimizer, updater and set of optimizer states serves every bucket
(``init_optimizer`` on the current bucket, ``borrow_optimizer`` for the
others and for buckets bound later); the JAX module gives each bucket an
optimizer and states of its own (ROADMAP.md C14).

On the card each bucket's executor is its own CUDA graph pair (compile
site ``executor``), captured at the bucket's second training batch and
replayed after that.
"""
from __future__ import annotations

import logging

from .. import initializer as init_mod
from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """Modules generated per bucket key, sharing one set of parameters."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule needs a default_bucket_key")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._module_kwargs = dict(
            work_load_list=work_load_list,
            fixed_param_names=fixed_param_names, state_names=state_names,
            group2ctxs=group2ctxs, compression_params=compression_params)
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._monitor = None
        self._grad_req = "write"

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        return self._curr_module.symbol

    @property
    def data_names(self):
        return self._curr_module.data_names

    @property
    def output_names(self):
        return self._curr_module.output_names

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        return self._curr_module.output_shapes

    # -------------------------------------------------------------- bind --
    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names=data_names, label_names=label_names,
                      logger=self.logger, context=self._context,
                      **self._module_kwargs)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket's Module for these shapes (the
        default bucket's); a rebind keeps the parameter values."""
        if shared_module is not None:
            raise MXNetError("BucketingModule.bind takes no shared_module")
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        kept = self.get_params() if self.params_initialized else None
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        mod = self._gen_module(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                 grad_req=grad_req)
        self._buckets = {self._default_bucket_key: mod}
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True
        if kept is not None:
            self.params_initialized = False
            self.set_params(*kept)

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s Module current, binding it first (over
        the default bucket's arrays, with its optimizer) when it is
        new."""
        if not self.binded:
            raise MXNetError("call bind before switch_bucket")
        if bucket_key not in self._buckets:
            mod = self._gen_module(bucket_key)
            mod.bind(data_shapes, label_shapes, self.for_training,
                     self.inputs_need_grad, grad_req=self._grad_req,
                     shared_module=self._buckets[self._default_bucket_key])
            if self._monitor is not None:
                mod.install_monitor(self._monitor)
            self._buckets[bucket_key] = mod
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    # ------------------------------------------------------------ params --
    def init_params(self, initializer=init_mod.Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """``Module.init_params`` on the current bucket, whose arrays
        every bucket shares."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        self._curr_module.init_params(initializer, arg_params, aux_params,
                                      allow_missing, force_init, allow_extra)
        self.params_initialized = True

    def get_params(self):
        return self._curr_module.get_params()

    # --------------------------------------------------------- optimizer --
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The current bucket's optimizer (``Module.init_optimizer``),
        which every other bucket borrows."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("init_optimizer needs a bound module with "
                             "parameters")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    # ----------------------------------------------------------- execute --
    def forward(self, data_batch, is_train=None):
        """Switch to the batch's bucket (``bucket_key``; the default
        bucket when it has none) and run its forward."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("forward needs a bound module with parameters")
        key = data_batch.bucket_key
        if key is None:
            key = self._default_bucket_key
        self.switch_bucket(
            key, data_batch.provide_data or [a.shape for a in data_batch.data],
            data_batch.provide_label or
            [a.shape for a in data_batch.label or []])
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        if not self.optimizer_initialized:
            raise MXNetError("update needs init_optimizer first")
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        if not self.binded:
            raise MXNetError("install_monitor needs a bound module")
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    # -------------------------------------------------------- checkpoint --
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """The default bucket's ``prefix-symbol.json``, the shared
        parameters as ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states`` (the JAX
        package's layout)."""
        self._buckets[self._default_bucket_key].save_checkpoint(
            prefix, epoch, save_optimizer_states)

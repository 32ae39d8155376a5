"""Gluon Trainer: eager optimizer steps over a block's Parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (``Trainer`` :21-192;
MXNet 1.x ``python/mxnet/gluon/trainer.py``). After ``loss.backward()``
under ``autograd.record()``, ``step(batch_size)``

1. reduces the gradients through the kvstore, when there is one: every
   gradient is pushed first, in one call in backward order, so a dist
   store's buckets reduce in that order (with 2-bit compression, after
   one compress launch over all of them), and then pulled back into each
   Parameter's gradient buffer in one call;
2. runs the optimizer once over every parameter whose gradient is fresh
   (``Optimizer.fused_update_multi``: on the card one launch of the fused
   SGD-momentum or Adam kernel), with ``rescale_grad = 1 / batch_size``.

The kvstore decision table is the JAX package's (:70-87): ``"device"``,
``"local"``, ``"nccl"`` and ``"local_*"`` mean no store (one process, the
gradients are already whole); another string creates that store
(``dist_sync`` and its aliases); a KVStore object is used as it is. With
a store, each trainable parameter's weights initialise its key.
``compression_params`` is kept and not applied, as in the JAX package:
call ``kv.set_gradient_compression`` on the store. Update-on-kvstore is
not used (``update_on_kvstore`` is accepted and ignored, as there).
"""
from __future__ import annotations

import pickle

from .. import optimizer as opt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             f"Parameters, got {type(params)}.")
        self._params = []
        self._param2idx = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 f"Parameters, got list of {type(param)}.")
            self._param2idx[param.name] = i
            self._params.append(param)
        self._compression_params = compression_params
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_type = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = update_on_kvstore
        self._states = [None] * len(self._params)
        self._states_created = False

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)

    def _create_states(self):
        for i, param in enumerate(self._params):
            if param.grad_req != "null" and self._states[i] is None:
                self._states[i] = self._optimizer.create_state_multi_precision(
                    i, param.data())
        self._states_created = True

    def _init_kvstore(self):
        kv = self._kvstore_type
        if isinstance(kv, str):
            if kv in ("device", "local", "nccl") or kv.startswith("local"):
                self._kvstore = None   # one process: nothing to reduce
            else:
                from .. import kvstore as kv_mod

                self._kvstore = kv_mod.create(kv)
        else:
            self._kvstore = kv
        if self._kvstore is not None:
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    self._kvstore.init(i, param.data())
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @learning_rate.setter
    def learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients and apply one optimizer step, with the
        gradients scaled by ``1 / batch_size``."""
        if not self._kv_initialized:
            self._init_kvstore()
        if not self._states_created:
            self._create_states()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Reduce the gradients through the kvstore only (then call
        ``update``)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        live = [(i, p.grad()) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if not live:
            return
        keys, grads = (list(x) for x in zip(*live))
        # one push call in backward order, then one pull call: a dist
        # store compresses every gradient with one launch and scales them
        # back with one
        self._kvstore.push(keys[::-1], grads[::-1])
        self._kvstore.pull(keys, grads)

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer step alone (after ``allreduce_grads``)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if not self._states_created:
            self._create_states()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        indices, weights, grads, states = [], [], [], []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if not param._fresh_grad:
                if ignore_stale_grad:
                    continue   # not used in this iteration: no update
                raise UserWarning(
                    f"Gradient of Parameter `{param.name}` has not been "
                    "updated by backward since last `step`. This could mean "
                    "a bug in your model that made it only use a subset of "
                    "the Parameters for this iteration. If you are "
                    "intentionally only using a subset, call step with "
                    "ignore_stale_grad=True to suppress this warning and "
                    "skip updating of Parameters with stale gradient")
            indices.append(i)
            weights.append(param.data())
            grads.append(param.grad())
            states.append(self._states[i])
            param._fresh_grad = False
        if indices:
            self._optimizer.fused_update_multi(indices, weights, grads,
                                               states)

    def save_states(self, fname):
        """Pickle the optimizer states and hyper-parameters."""
        if not self._states_created:
            self._create_states()
        with open(fname, "wb") as f:
            pickle.dump((self._states, self._optimizer.__getstate__()), f)

    def load_states(self, fname):
        """Load what :meth:`save_states` wrote (this program's own
        files: unpickling runs code)."""
        with open(fname, "rb") as f:
            states, opt_state = pickle.load(f)
        self._states_created = True
        self._states = states
        self._optimizer.__setstate__(
            {**self._optimizer.__getstate__(),
             **{k: v for k, v in opt_state.items() if k != "param_dict"}})

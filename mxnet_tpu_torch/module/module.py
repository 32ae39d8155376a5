"""Module: MXNet 1.x's intermediate-level symbolic training interface.

Counterpart of ``mxnet_tpu/module/module.py`` (MXNet 1.x
``python/mxnet/module/module.py``): ``bind`` (through
``Symbol.simple_bind``), ``init_params`` (the initializer called with an
``InitDesc`` per parameter and auxiliary state), ``init_optimizer``,
``forward``, ``backward``, ``update``, ``update_metric``,
``install_monitor``, ``save_checkpoint`` / ``load`` and the optimizer
states. One :class:`~mxnet_tpu_torch.executor.Executor` on one card
holds the graph; a context list of several cards raises (ROADMAP.md, multi-card
data parallelism).

Where the JAX package and MXNet 1.x differ, the port follows MXNet 1.x:

* ``init_optimizer`` with an optimizer name sets ``rescale_grad`` to
  ``1 / batch_size`` unless the caller gives one, and names the
  parameters (``param_idx2name``), so biases and BatchNorm betas get no
  weight decay; the JAX ``Module`` does neither (ROADMAP.md C8).
* ``init_params`` initializes the auxiliary states too (BatchNorm's
  running variance to ones), and ``Module.load`` then ``bind`` restores
  the saved parameters.
* The kvstore follows MXNet's ``_create_kvstore``: a store object (as
  ``common/fit.py`` passes) updates the weights on the store (push the
  gradients, pull the weights); a type name with one card and no
  ``dist`` uses no store and updates in place.

``bind(shared_module=)`` binds the parameters, their gradients and the
auxiliary states to the arrays of another module (one storage for
every bucket of a ``BucketingModule``) and borrows its optimizer.

``update`` pushes every parameter's gradient in one ``push`` call and
pulls every weight in one ``pull`` call (the JAX ``Module`` pushes and
pulls key by key): the local store hands the list to
``Updater.update_multi`` (one fused K1 launch per learning-rate group
for SGD with momentum) and copies the weights back with one
multi-tensor copy. It stays eager, as the JAX ``Module``'s does; the
executor's forward and backward replay CUDA graphs on the card
(compile site ``executor``), and the metric's one host copy a batch
stays outside them.
"""
from __future__ import annotations

import logging
import warnings

import torch

from .. import initializer as init_mod
from .. import optimizer as opt_mod
from .. import random as _random
from ..base import MXNetError
from ..io import DataDesc
from ..ndarray import NDArray
from ..symbol.symbol import _one_context
from .base_module import BaseModule

__all__ = ["Module"]


class Module(BaseModule):
    """A symbol bound to one executor, with its optimizer."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if compression_params:
            raise MXNetError("gradient compression in Module needs a dist "
                             "kvstore, which Module does not drive yet; see "
                             "ROADMAP.md, multi-card data parallelism")
        if work_load_list is not None and len(work_load_list) != 1:
            raise MXNetError("work_load_list splits a batch over several "
                             "contexts; Module binds one; see ROADMAP.md, "
                             "multi-card data parallelism")
        if group2ctxs is not None:
            raise MXNetError("group2ctxs (placing ctx_group parts of the "
                             "graph on their own contexts) is not ported; "
                             "see ROADMAP.md, ctx_group placement")
        self._context = _one_context(context)
        self._context.torch_device()   # no card: raise here, not at bind
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._state_names = list(state_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        arg_names = symbol.list_arguments()
        inputs = set(self._data_names + self._label_names + self._state_names)
        missing = [n for n in self._data_names if n not in arg_names]
        if missing:
            raise MXNetError(f"data names {missing} are not arguments of "
                             "the symbol")
        self._param_names = [n for n in arg_names if n not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._arg_params = None      # values to bind with (Module.load)
        self._aux_params = None
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._updater = None
        self._preload_opt_states = None
        self._data_shapes = None
        self._label_shapes = None

    # -------------------------------------------------------------- bind --
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Allocate the executor's arrays for these input shapes."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None and not (
                isinstance(shared_module, Module) and shared_module.binded
                and shared_module.params_initialized):
            raise MXNetError("bind(shared_module=) needs a bound Module "
                             "with initialized parameters")
        old = self._exec if self.params_initialized and \
            shared_module is None else None
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = [_as_desc(d, self._data_names, i)
                             for i, d in enumerate(data_shapes)]
        self._label_shapes = [_as_desc(d, self._label_names, i)
                              for i, d in enumerate(label_shapes or [])]
        inputs = self._data_shapes + self._label_shapes
        req = {}
        for name in self._param_names:
            if name in self._fixed_param_names or not for_training:
                req[name] = "null"
            elif isinstance(grad_req, dict):
                req[name] = grad_req.get(name, "write")
            else:
                req[name] = grad_req
        if for_training and inputs_need_grad:
            req.update(dict.fromkeys(self._data_names, "write"))
        self._exec = self._symbol.simple_bind(
            self._context, grad_req=req,
            type_dict={d.name: d.dtype for d in inputs},
            **{d.name: d.shape for d in inputs})
        self.binded = True
        if shared_module is not None:
            self._share(shared_module)
        elif old is not None:
            self._exec.copy_params_from(
                {n: old.arg_dict[n] for n in self._param_names},
                {n: old.aux_dict[n] for n in self._aux_names})
        elif self._arg_params is not None:
            self._exec.copy_params_from(self._arg_params, self._aux_params,
                                        allow_extra_params=True)

    def _share(self, shared):
        """Bind this executor's parameters, their gradients and the
        auxiliary states to ``shared``'s arrays wherever ``shared`` has
        one of that name (MXNet 1.x's ``shared_module``: one storage for
        every bucket of a ``BucketingModule``), and borrow its optimizer
        when it has one."""
        mine, theirs = self._exec, shared._exec
        for dst, src, names in (
                (mine.arg_dict, theirs.arg_dict, self._param_names),
                (mine.grad_dict, theirs.grad_dict, self._param_names),
                (mine.aux_dict, theirs.aux_dict, self._aux_names)):
            for name in names:
                if name not in dst or name not in src:
                    continue
                if dst[name].shape != src[name].shape:
                    raise MXNetError(
                        f"shared_module: {name!r} has shape "
                        f"{dst[name].shape} here and {src[name].shape} in "
                        "the shared module")
                dst[name] = src[name]
        self.params_initialized = True
        if shared.optimizer_initialized:
            self.borrow_optimizer(shared)

    def borrow_optimizer(self, shared_module):
        """Use ``shared_module``'s optimizer, kvstore and updater (and
        with them its optimizer states)."""
        if not shared_module.optimizer_initialized:
            raise MXNetError("borrow_optimizer: the shared module has no "
                             "optimizer")
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind for new input shapes, sharing the parameters (growing
        the inputs' arrays where needed, as MXNet's executor group
        does)."""
        self._data_shapes = [_as_desc(d, self._data_names, i)
                             for i, d in enumerate(data_shapes)]
        self._label_shapes = [_as_desc(d, self._label_names, i)
                              for i, d in enumerate(label_shapes or [])]
        self._exec = self._exec.reshape(
            allow_up_sizing=True,
            **{d.name: d.shape
               for d in self._data_shapes + self._label_shapes})

    # ------------------------------------------------------------ params --
    def init_params(self, initializer=init_mod.Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Each parameter and auxiliary state from ``arg_params`` /
        ``aux_params`` where given, else from ``initializer`` (called
        with an ``InitDesc`` carrying the variable's graph attributes,
        drawing from ``mx.random``'s CPU generator); a missing value
        without ``allow_missing`` raises."""
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init="
                          "False. init_params call ignored.", stacklevel=2)
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        attrs = _var_attrs(self._symbol)
        gen = _random.generator(torch.device("cpu"))

        def impl(name, arr, cache):
            if cache is not None and name in cache:
                value = cache[name]
            elif cache is not None and not allow_missing:
                raise MXNetError(f"{name} is not presented")
            elif initializer is None:
                return
            else:
                value = initializer(init_mod.InitDesc(name, attrs.get(name)),
                                    arr.shape, arr.dtype, gen)
            with torch.no_grad():
                arr._data.copy_(value._data if isinstance(value, NDArray)
                                else torch.as_tensor(value))

        for name in self._param_names:
            impl(name, self._exec.arg_dict[name], arg_params)
        for name in self._aux_names:
            impl(name, self._exec.aux_dict[name], aux_params)
        self.params_initialized = True
        self._arg_params = self._aux_params = None

    def get_params(self):
        """Copies of the parameters and auxiliary states, by name."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("get_params needs a bound module with "
                             "parameters")
        def copies(arrays, names):
            return {n: NDArray(arrays[n]._data.detach().clone())
                    for n in names}

        return (copies(self._exec.arg_dict, self._param_names),
                copies(self._exec.aux_dict, self._aux_names))

    # --------------------------------------------------------- optimizer --
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer, and the kvstore by MXNet's ``_create_kvstore``
        rule. An optimizer name is created with ``rescale_grad = 1 /
        batch_size`` unless ``optimizer_params`` gives one, and with the
        parameter names (``param_idx2name``)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("init_optimizer needs a bound module with "
                             "parameters")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        kv, update_on_kvstore = _create_kvstore(kvstore)
        batch_size = self._data_shapes[0].shape[0]
        if kv is not None and "dist" in kv.type and "_sync" in kv.type:
            batch_size *= kv.num_workers
        rescale_grad = 1.0 / batch_size
        idx2name = dict(enumerate(self._param_names))
        if isinstance(optimizer, str):
            params = dict(optimizer_params)
            params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt_mod.create(optimizer, sym=self._symbol,
                                       param_idx2name=idx2name, **params)
        else:
            if not isinstance(optimizer, opt_mod.Optimizer):
                raise TypeError(f"optimizer must be a name or an Optimizer, "
                                f"got {type(optimizer).__name__}")
            if optimizer.rescale_grad != rescale_grad:
                warnings.warn(
                    f"Optimizer created manually outside Module but "
                    f"rescale_grad is not normalized to 1.0/batch_size/"
                    f"num_workers ({optimizer.rescale_grad} vs. "
                    f"{rescale_grad}). Is this intended?", stacklevel=2)
            if not optimizer.idx2name:
                optimizer.idx2name = idx2name.copy()
        self._optimizer = optimizer
        self._kvstore = kv
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kv is not None:
            if update_on_kvstore:
                kv.set_optimizer(optimizer)
            names = self._param_names
            kv.init(names, [self._exec.arg_dict[n] for n in names])
            if update_on_kvstore:
                kv.pull(names, out=[self._exec.arg_dict[n] for n in names])
        if not update_on_kvstore:
            self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # ----------------------------------------------------------- execute --
    def forward(self, data_batch, is_train=None):
        """Feed the batch's data (and labels, where the graph takes
        them) and run the executor; a batch of other shapes rebinds
        first."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("forward needs a bound module with parameters")
        if is_train is None:
            is_train = self.for_training
        data = list(data_batch.data)
        labels = list(data_batch.label or [])
        if [tuple(a.shape) for a in data] != \
                [d.shape for d in self._data_shapes]:
            label_shapes = [(d.name, tuple(a.shape)) for d, a in
                            zip(self._label_shapes, labels)] or None
            self.reshape([(d.name, tuple(a.shape)) for d, a in
                          zip(self._data_shapes, data)], label_shapes)
        feed = dict(zip(self._data_names, data))
        feed.update((n, a) for n, a in zip(self._label_names, labels)
                    if n in self._exec.arg_dict)
        self._exec.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("backward needs a bound module with parameters")
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step over every parameter that has a gradient:
        on the store (one push, one pull), through the store's sum then
        the local updater, or locally (``Updater.update_multi``)."""
        if not self.optimizer_initialized:
            raise MXNetError("update needs init_optimizer first")
        grads = self._exec.grad_dict
        names = [n for n in self._param_names if n in grads]
        if not names:
            return
        g = [grads[n] for n in names]
        w = [self._exec.arg_dict[n] for n in names]
        if self._update_on_kvstore:
            self._kvstore.push(names, g)
            self._kvstore.pull(names, out=w)
            return
        if self._kvstore is not None:
            self._kvstore.push(names, g)
            self._kvstore.pull(names, out=g)
        self._updater.update_multi(
            [self._param_names.index(n) for n in names], g, w)

    def get_outputs(self, merge_multi_context=True):
        return list(self._exec.outputs)

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True for input "
                             "gradients")
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        if not self.binded:
            raise MXNetError("install_monitor needs a bound module")
        mon.install(self._exec)

    # -------------------------------------------------------- checkpoint --
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states``."""
        from .. import model as model_mod

        arg, aux = self.get_params()
        model_mod.save_checkpoint(prefix, epoch, self._symbol, arg, aux)
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint: ``bind`` writes the saved
        parameters into the executor, and ``init_optimizer`` reads the
        optimizer states when ``load_optimizer_states``."""
        from .. import model as model_mod
        from ..context import cpu

        sym, args, auxs = model_mod.load_checkpoint(prefix, epoch, ctx=cpu())
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod

    def save_optimizer_states(self, fname):
        if not self.optimizer_initialized:
            raise MXNetError("no optimizer states before init_optimizer")
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            with open(fname, "wb") as f:
                f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if not self.optimizer_initialized:
            raise MXNetError("no optimizer states before init_optimizer")
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())

    # -------------------------------------------------------- properties --
    @property
    def data_names(self):
        return list(self._data_names)

    @property
    def label_names(self):
        return list(self._label_names)

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        if not self._exec or not self._exec.outputs:
            return None
        return [(n, o.shape) for n, o in
                zip(self.output_names, self._exec.outputs)]


def _create_kvstore(kvstore):
    """``(store or None, update_on_kvstore)`` by MXNet 1.x's rule for one
    card: a store object is used (with the optimizer on it when it can
    hold one); a type name is created only for ``dist`` types."""
    from .. import kvstore as kv_mod

    if kvstore is None:
        return None, False
    if isinstance(kvstore, str):
        if "dist" not in kvstore:
            return None, False
        kvstore = kv_mod.create(kvstore)
    return kvstore, kvstore.is_capable(kv_mod.KVStoreBase.OPTIMIZER)


def _var_attrs(symbol):
    """``{variable name: its attributes}`` of the graph's inputs."""
    from ..symbol.symbol import _topo

    return {n.name: dict(n.attrs) for n in _topo(symbol._entries)
            if n.is_var}


def _as_desc(d, names, i):
    if isinstance(d, DataDesc):
        return d
    if isinstance(d, tuple) and len(d) == 2 and isinstance(d[0], str):
        return DataDesc(d[0], tuple(d[1]))
    return DataDesc(names[i] if i < len(names) else f"input{i}", tuple(d))

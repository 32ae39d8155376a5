"""Checkpoints of a graph and its parameters, and ``FeedForward``.

Counterpart of ``mxnet_tpu/model.py`` (``save_checkpoint`` :16,
``load_params`` :32, ``load_checkpoint`` :64, ``FeedForward`` :87-213,
and the re-export of ``BatchEndParam`` :13): ``prefix-symbol.json`` +
``prefix-%04d.params``, the parameters keyed ``arg:<name>`` /
``aux:<name>``. The files are the JAX package's format both ways.
Each file is written to a temporary name and renamed into place, so a
run killed during a save leaves the previous file whole.
``FeedForward``, MXNet 1.x's legacy model API, trains and predicts
through :class:`~mxnet_tpu_torch.module.Module`.
"""
from __future__ import annotations

import logging
import os
import zipfile

from .module.base_module import BatchEndParam  # noqa: F401  (re-export)

__all__ = ["save_checkpoint", "load_params", "load_checkpoint",
           "FeedForward", "BatchEndParam"]


def _atomic_write(path, write):
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write(tmp)
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``symbol`` (unless None) and the ``{name: NDArray}``
    parameter dicts."""
    from .ndarray import utils as nd_utils

    if symbol is not None:
        _atomic_write(f"{prefix}-symbol.json", symbol.save)
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    _atomic_write(f"{prefix}-{epoch:04d}.params",
                  lambda tmp: nd_utils.save(tmp, save_dict))


def load_params(fname, ctx=None):
    """``(arg_params, aux_params)`` of a params file, on ``ctx``
    (default: the current context). Untagged names count as arguments."""
    from .ndarray import utils as nd_utils

    if not os.path.exists(fname):
        raise FileNotFoundError(f"params file not found: {fname!r}")
    try:
        loaded = nd_utils.load(fname, ctx=ctx)
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        raise ValueError(f"corrupt params file {fname!r}: "
                         f"{type(e).__name__}: {e}") from e
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        if k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k[4:] if k.startswith("arg:") else k] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch, ctx=None):
    """``(symbol, arg_params, aux_params)``, the parameters on ``ctx``."""
    from . import symbol as sym_mod

    sym_file = f"{prefix}-symbol.json"
    if not os.path.exists(sym_file):
        raise FileNotFoundError(f"symbol file not found: {sym_file!r} "
                                f"(checkpoint prefix {prefix!r}, epoch "
                                f"{epoch})")
    symbol = sym_mod.load(sym_file)
    arg_params, aux_params = load_params(f"{prefix}-{epoch:04d}.params",
                                         ctx=ctx)
    return symbol, arg_params, aux_params


class FeedForward:
    """MXNet 1.x's legacy model API over :class:`Module`: ``fit`` on
    arrays or a data iterator, ``predict``, ``score``, ``save``,
    ``load`` and ``create``. Keyword arguments beyond the named ones are
    the optimizer's parameters."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as init_mod

        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or init_mod.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        from .module import Module

        mod = Module(self.symbol, context=self.ctx, logger=logger or logging,
                     work_load_list=work_load_list)
        mod.fit(self._as_iter(X, y), eval_data=eval_data,
                eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer, optimizer_params=self.kwargs,
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params,
                allow_missing=self.arg_params is not None,
                begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch or 1, monitor=monitor,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback)
        self._module = mod
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs as a numpy array."""
        out = self._bound_module(X).predict(self._as_iter(X),
                                            num_batch=num_batch, reset=reset)
        return out.asnumpy()

    def score(self, X, eval_metric="acc", num_batch=None, **kwargs):
        """The first metric's value over ``X``."""
        res = self._bound_module(X).score(self._as_iter(X), eval_metric,
                                          num_batch=num_batch)
        return res[0][1]

    def save(self, prefix, epoch=None):
        epoch = self.num_epoch if epoch is None else epoch
        save_checkpoint(prefix, epoch or 0, self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        from .context import cpu

        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch,
                                                         ctx=cpu())
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """A FeedForward, fitted."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        return model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                         epoch_end_callback=epoch_end_callback,
                         batch_end_callback=batch_end_callback,
                         kvstore=kvstore, logger=logger,
                         work_load_list=work_load_list,
                         eval_end_callback=eval_end_callback,
                         eval_batch_end_callback=eval_batch_end_callback)

    def _as_iter(self, X, y=None):
        from .io import DataIter, NDArrayIter

        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, batch_size=min(self.numpy_batch_size,
                                                len(X)))

    def _bound_module(self, X):
        """The fitted module, or one bound for inference on the model's
        parameters (label inputs sized from the batch, unused)."""
        if self._module is not None:
            return self._module
        from .module import Module

        data = self._as_iter(X)
        labels = list(data.provide_label or [])
        if not labels:
            batch = data.provide_data[0][1][0]
            labels = [(n, (batch,)) for n in self.symbol.list_arguments()
                      if n.endswith("_label")]
        mod = Module(self.symbol, context=self.ctx)
        mod.bind(data.provide_data, labels or None, for_training=False)
        mod.set_params(self.arg_params or {}, self.aux_params or {})
        self._module = mod
        return mod

"""Monitor: statistics of an executor's arrays, for debugging.

Counterpart of ``mxnet_tpu/monitor.py`` (:20-101; MXNet 1.x
``python/mxnet/monitor.py``). As the JAX package's, it reports what the
bound executor holds (arguments, their gradients, auxiliary states and
outputs) every ``interval`` batches, not each op's intermediate outputs
(MXNet's per-op callback): ``Module.install_monitor`` installs it on the
Module's :class:`~mxnet_tpu_torch.executor.Executor`. The default
statistic is ``norm(x) / sqrt(x.size)``; names are filtered by the
regular expression ``pattern``.
"""
from __future__ import annotations

import logging
import math
import re

import torch

from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    """Collects ``(step, name, stat_func(array))`` between ``tic`` and
    ``toc`` every ``interval`` steps."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 monitor_all=False):
        if stat_func is None:
            def asum_stat(x):
                """norm(x) / sqrt(size), MXNet's default."""
                return NDArray(torch.linalg.vector_norm(
                    x._data.detach().float()) / math.sqrt(x.size))

            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort
        self.monitor_all = monitor_all

    def install(self, exe):
        """Watch an Executor's arrays."""
        self.exes.append(exe)

    def tic(self):
        """Start collecting for this batch; call before forward."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def _collect(self, exe):
        sym = exe._symbol
        seen = set()

        def emit(name, arr):
            if arr is None or id(arr) in seen:
                return
            seen.add(id(arr))
            if self.re_prog.match(name):
                self.queue.append((self.step, name, self.stat_func(arr)))

        for name, arr in zip(sym.list_arguments(), exe.arg_arrays):
            emit(name, arr)
            grad = exe.grad_dict.get(name)
            if grad is not None:
                emit(name + "_grad", grad)
        for name, arr in zip(sym.list_auxiliary_states(), exe.aux_arrays):
            emit(name, arr)
        for name, arr in zip(sym.list_outputs(), exe.outputs or []):
            emit(name, arr)

    def toc(self):
        """Finish collecting; returns [(step, name, stat_str)]."""
        if not self.activated:
            return []
        for exe in self.exes:
            self._collect(exe)
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            s = ""
            for v in v_list:
                if v.size == 1:
                    s += str(v.asscalar()) + "\t"
                else:
                    s += str(v.asnumpy()) + "\t"
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        """Log each collected statistic."""
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)

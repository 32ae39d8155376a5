"""Training callbacks.

Counterpart of ``mxnet_tpu/callback.py`` (MXNet 1.x
``python/mxnet/callback.py``): ``module_checkpoint``, ``do_checkpoint``,
``log_train_metric``, ``Speedometer``, ``ProgressBar`` and
``LogValidationMetricsCallback``. Each is a plain callable for
``Module.fit``'s ``batch_end_callback`` (called with a
``BatchEndParam``) or ``epoch_end_callback`` (called with the epoch,
the symbol and the parameter dicts). ``Speedometer``'s samples/sec is
the host clock's over the ``frequent`` batches between two of its log
lines, as MXNet 1.x's is.
"""
from __future__ import annotations

import logging
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback: ``mod.save_checkpoint`` every ``period``
    epochs."""
    period = max(1, int(period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving (symbol, arg, aux) checkpoints every
    `period` epochs."""
    from . import model as model_mod

    period = max(1, int(period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            model_mod.save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the training metric every `period`
    batches."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset_local()

    return _callback


class Speedometer:
    """Logs training speed and metrics every `frequent` batches
   ."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count

        if self.init:
            if count % self.frequent == 0:
                try:
                    speed = self.frequent * self.batch_size / \
                        (time.time() - self.tic)
                except ZeroDivisionError:
                    speed = float("inf")
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset_local()
                        msg = "Epoch[%d] Batch [%d-%d]\tSpeed: %.2f " \
                              "samples/sec"
                        msg += "\t%s=%f" * len(name_value)
                        logging.info(msg, param.epoch, count - self.frequent,
                                     count, speed, *sum(name_value, ()))
                    else:
                        msg = "Epoch[%d] Batch [0-%d]\tSpeed: %.2f " \
                              "samples/sec"
                        msg += "\t%s=%f" * len(name_value)
                        logging.info(msg, param.epoch, count, speed,
                                     *sum(name_value, ()))
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec", param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class ProgressBar:
    """Displays a progress bar reflecting batch progress within an epoch
   ."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    """Logs the eval metrics at the end of an epoch
   ."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f",
                         param.epoch, name, value)

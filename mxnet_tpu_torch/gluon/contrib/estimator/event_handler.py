"""Estimator event handlers (counterpart of
``mxnet_tpu/gluon/contrib/estimator/event_handler.py``, MXNet 1.x
``event_handler.py``): the mixins TrainBegin, TrainEnd, EpochBegin,
EpochEnd, BatchBegin and BatchEnd, and the stock handlers.
:class:`CheckpointHandler` stores through
:class:`mxnet_tpu_torch.checkpoint.CheckpointManager`; its files and
manifest are the JAX package's, so either package resumes the other's."""
from __future__ import annotations

import time

__all__ = ["TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd", "BatchBegin",
           "BatchEnd", "StoppingHandler", "LoggingHandler",
           "CheckpointHandler", "EarlyStoppingHandler"]


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop after ``max_epoch`` epochs or ``max_batch`` batches (MXNet
    1.x ``event_handler.py:69``)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch >= self.max_batch:
            estimator.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch >= self.max_epoch:
            estimator.stop_training = True


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchEnd):
    """Log the speed and the metrics (MXNet 1.x
    ``event_handler.py:116``)."""

    def __init__(self, log_interval="epoch", metrics=None):
        self.log_interval = log_interval
        self.metrics = metrics or []
        self.batch_index = 0
        self.processed_samples = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        estimator.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        estimator.logger.info("Train finished using total %ds",
                              time.time() - self.train_start)
        for metric in self.metrics:
            name, value = metric.get()
            estimator.logger.info("Train end: %s: %.4f", name, value)

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()
        self.batch_index = 0
        self.processed_samples = 0

    def epoch_end(self, estimator, *args, **kwargs):
        msg = "Epoch finished in %.3fs: " % (time.time() - self.epoch_start)
        for metric in self.metrics:
            name, value = metric.get()
            msg += f"{name}: {value:.4f}, "
        estimator.logger.info(msg.rstrip(", "))

    def batch_end(self, estimator, *args, **kwargs):
        if isinstance(self.log_interval, int):
            batch_size = kwargs.get("batch_size", 0)
            self.processed_samples += batch_size
            self.batch_index += 1
            if self.batch_index % self.log_interval == 0:
                msg = f"[Batch {self.batch_index}] "
                for metric in self.metrics:
                    name, value = metric.get()
                    msg += f"{name}: {value:.4f}, "
                estimator.logger.info(msg.rstrip(", "))


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Save the parameters every ``epoch_period`` epochs (MXNet 1.x
    ``event_handler.py:308``) through a ``CheckpointManager``: atomic,
    CRC-checked writes, ``max_checkpoints`` epochs kept, and with
    ``resume_from_checkpoint`` the newest good checkpoint loaded at
    ``train_begin`` (a corrupt file falls back to the one before)."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 save_best=False, epoch_period=1, max_checkpoints=5,
                 resume_from_checkpoint=False):
        from ....checkpoint import CheckpointManager

        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.epoch_period = epoch_period
        self.monitor = monitor
        self.save_best = save_best
        self.max_checkpoints = max_checkpoints
        self.resume_from_checkpoint = resume_from_checkpoint
        self.best = None
        self.current_epoch = 0
        self.trained_epochs = 0  # restored on resume
        self._manager = CheckpointManager(model_dir, prefix=model_prefix,
                                          keep=max_checkpoints)

    def train_begin(self, estimator, *args, **kwargs):
        if not self.resume_from_checkpoint:
            return
        res = self._manager.resume()
        if res is None:
            estimator.logger.info(
                "CheckpointHandler: no checkpoint to resume from in %s; "
                "starting fresh", self.model_dir)
            return
        entry, paths = res
        estimator.net.load_parameters(paths["params"])
        self.current_epoch = self.trained_epochs = entry["epoch"]
        self.best = entry["meta"].get("best")
        estimator.logger.info(
            "CheckpointHandler: resumed epoch %d from %s",
            entry["epoch"], paths["params"])

    def epoch_end(self, estimator, *args, **kwargs):
        import os

        self.current_epoch += 1
        if self.current_epoch % self.epoch_period:
            return
        meta = {}
        if self.best is not None:
            meta["best"] = self.best
        self._manager.save(
            self.current_epoch,
            {"params": estimator.net.save_parameters},
            meta=meta)
        if self.save_best and self.monitor is not None:
            from ....checkpoint import atomic_write

            _, value = self.monitor.get()
            if self.best is None or value > self.best:
                self.best = value
                prefix = os.path.join(self.model_dir, self.model_prefix)
                atomic_write(f"{prefix}-best.params",
                             estimator.net.save_parameters)

    def drain_save(self, estimator):
        """The drain's save (``Estimator._drain``): one mid-epoch
        checkpoint at ``current_epoch + 1`` with ``meta.drain`` holding
        the drain event, so a resumed run can tell a partial epoch from a
        finished one."""
        from .... import preempt as _preempt

        meta = {"drain": _preempt.event() or True}
        if self.best is not None:
            meta["best"] = self.best
        self._manager.save(
            self.current_epoch + 1,
            {"params": estimator.net.save_parameters},
            meta=meta)


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Stop when the monitored metric stops improving (MXNet 1.x
    ``event_handler.py:514``)."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto"):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        if mode == "min" or (mode == "auto" and
                             "loss" in monitor.get()[0]):
            self.improved = lambda new, best: new < best - self.min_delta
        else:
            self.improved = lambda new, best: new > best + self.min_delta
        self.best = None
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        _, value = self.monitor.get()
        if self.best is None or self.improved(value, self.best):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = self.current_epoch
                estimator.stop_training = True

    def train_end(self, estimator, *args, **kwargs):
        if self.stopped_epoch:
            estimator.logger.info("Epoch %d: early stopping",
                                  self.stopped_epoch)

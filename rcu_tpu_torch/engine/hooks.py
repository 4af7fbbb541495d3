"""Train- and test-loop hooks (``rcu_tpu.engine.hooks`` counterparts):
console logs, tensorboard scalars, the per-subject validation CSV, the
checkpoint retention (one -best checkpoint, the 3 last epochs), and the
test loop's console log and ``metrics.csv``.

The per-step metrics are tensors on the device; a hook fetches them at
its own cadence, so the loop never waits on a step. ``tensorboardX`` is
imported by :class:`TensorboardHook` alone.
"""
from __future__ import annotations

import csv
import logging
import os
import time
import typing

import numpy as np
import torch

from rcu_tpu_torch.engine import checkpoint as ckpt_lib


class TrainLoopHook:
    def on_startup(self, loop): pass
    def on_epoch_start(self, loop, epoch: int): pass
    def on_training_batch_end(self, loop, epoch: int, batch_index: int,
                              nb_batches: int, metrics: dict): pass
    def on_training_end(self, loop, epoch: int, metrics_mean: dict): pass
    def on_validation_subject_end(self, loop, epoch: int, subject: str,
                                  results: dict): pass
    def on_validation_end(self, loop, epoch: int, score: float, is_best: bool,
                          subject_results: list): pass
    def on_epoch_end(self, loop, epoch: int): pass
    def on_termination(self, loop): pass


class _ComposeHooks:
    """Shared fan-out dispatch: every ``on_*`` access returns a callable that
    invokes the event on each composed hook in order."""

    def __init__(self, hooks: list):
        self.hooks = list(hooks)

    def __getattribute__(self, name):
        if name.startswith("on_"):
            hooks = object.__getattribute__(self, "hooks")

            def fan_out(*args, **kwargs):
                for h in hooks:
                    getattr(h, name)(*args, **kwargs)
            return fan_out
        return object.__getattribute__(self, name)


class ComposeTrainHook(_ComposeHooks, TrainLoopHook):
    pass


class ConsoleLogHook(TrainLoopHook):
    """Timed cadence logs."""

    def __init__(self, log_every_nth: int = 10):
        self.log_every_nth = log_every_nth
        self._batch_t0 = None

    def on_startup(self, loop):
        logging.info("train run %s (%s)", loop.run_id, loop.run_dir)
        logging.info("model parameters: %s",
                     f"{loop.nb_params:,}" if loop.nb_params else "?")

    def on_epoch_start(self, loop, epoch):
        logging.info("epoch %d/%d", epoch + 1, loop.config.epochs)
        self._batch_t0 = time.time()

    def on_training_batch_end(self, loop, epoch, batch_index, nb_batches, metrics):
        if (batch_index + 1) % self.log_every_nth == 0:
            dt = time.time() - self._batch_t0
            self._batch_t0 = time.time()
            stats = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
            logging.info("  [%d/%d] %s (%.2fs/%db)", batch_index + 1, nb_batches,
                         stats, dt, self.log_every_nth)

    def on_validation_end(self, loop, epoch, score, is_best, subject_results):
        logging.info("  validation score %.4f%s", score, " (new best)" if is_best else "")


class TensorboardHook(TrainLoopHook):
    """Train-step scalars and per-epoch validation means. The per-step
    scalars wait on the device and are fetched in one copy per
    ``flush_every`` steps and at the end of each epoch."""

    def __init__(self, log_dir: str, flush_every: int = 64):
        import tensorboardX
        self.writer = tensorboardX.SummaryWriter(log_dir)
        self.flush_every = flush_every
        self._pending: typing.List[tuple] = []

    def _flush(self):
        if self._pending:
            values = iter(torch.stack([torch.as_tensor(v).float().reshape(())
                                       for _, m in self._pending
                                       for v in m.values()]).tolist())
            for step, metrics in self._pending:
                for k in metrics:
                    self.writer.add_scalar(f"train/{k}", next(values), step)
        self._pending.clear()

    def on_training_batch_end(self, loop, epoch, batch_index, nb_batches, metrics):
        # global step derives from (epoch, batch) — not a session counter —
        # so a resumed run continues its curves instead of re-logging from 0
        self._pending.append((epoch * nb_batches + batch_index, dict(metrics)))
        # windowed flush: bounds both the scalars lost to a mid-epoch crash
        # and the tiny device buffers pinned by the pending list, while
        # keeping device round-trips ~flush_every x rarer than per-step
        if len(self._pending) >= self.flush_every:
            self._flush()

    def on_training_end(self, loop, epoch, metrics_mean):
        self._flush()

    def on_validation_end(self, loop, epoch, score, is_best, subject_results):
        self.writer.add_scalar("valid/score", float(score), epoch)
        if subject_results:
            keys = [k for k, v in subject_results[0].items()
                    if isinstance(v, (int, float, np.floating, np.integer))]
            for k in keys:
                self.writer.add_scalar(
                    f"valid/{k}",
                    float(np.mean([r[k] for r in subject_results])), epoch)

    def on_termination(self, loop):
        self.writer.close()


class SaveBestModelHook(TrainLoopHook):
    """Keep exactly one '-best' checkpoint."""

    def on_validation_end(self, loop, epoch, score, is_best, subject_results):
        if not is_best:
            return
        prev = ckpt_lib.find_best_checkpoint_epoch(loop.model_files)
        # save the new best BEFORE deleting the old one: a crash between the
        # two must never leave the run without any -best checkpoint
        loop.save_checkpoint(epoch, best=True)
        if prev is not None and prev != epoch:
            ckpt_lib.delete_checkpoint(loop.model_files, prev, best=True)


class SaveNLastModelHook(TrainLoopHook):
    """The ``keep_nb`` last epoch checkpoints."""

    def __init__(self, keep_nb: int = 3):
        self.keep_nb = keep_nb
        self._saved: typing.List[int] = []

    def on_startup(self, loop):
        # resume: adopt the epoch checkpoints already on disk so the keep-n
        # window keeps rolling instead of accumulating pre-resume files
        self._saved = ckpt_lib.find_epoch_checkpoints(loop.model_files)

    def on_epoch_end(self, loop, epoch):
        loop.save_checkpoint(epoch, best=False)
        self._saved.append(epoch)
        while len(self._saved) > self.keep_nb:
            ckpt_lib.delete_checkpoint(loop.model_files, self._saved.pop(0))


class WriteValidationMetricsCsvHook(TrainLoopHook):
    """Per-subject validation metric rows, the whole file rewritten at each
    validation."""

    def __init__(self, file_path: str):
        self.file_path = file_path
        self._rows = []
        self._header = None
        # resume: keep the pre-resume epochs' rows — the file is rewritten
        # whole on every validation, so starting empty would erase them
        if os.path.exists(file_path):
            with open(file_path, newline="") as f:
                existing = list(csv.reader(f))
            if existing:
                self._header = existing[0]
                self._rows = existing[1:]

    def on_startup(self, loop):
        # a run resumed from a checkpoint EARLIER than its last validation
        # re-runs those epochs: drop their preloaded rows or the rewritten
        # CSV would interleave stale and fresh rows for the same epoch
        resume_at = getattr(loop, "resume_epoch", None)
        if resume_at is not None and self._rows:
            self._rows = [r for r in self._rows if int(r[0]) <= resume_at]

    def on_validation_subject_end(self, loop, epoch, subject, results):
        if self._header is None:
            self._header = ["epoch", "subject"] + sorted(results.keys())
        self._rows.append([epoch, subject] + [results[k] for k in self._header[2:]])

    def on_validation_end(self, loop, epoch, score, is_best, subject_results):
        with open(self.file_path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(self._header or ["epoch", "subject"])
            writer.writerows(self._rows)


class TestLoopHook:
    __test__ = False  # not a pytest class

    def on_startup(self, loop): pass
    def on_test_batch_end(self, loop, batch_index: int, nb_batches: int): pass
    def on_test_subject_end(self, loop, subject: str, subject_data: dict,
                            results: dict): pass
    def on_test_end(self, loop, subject_results: list): pass
    def on_termination(self, loop): pass


class ComposeTestHook(_ComposeHooks, TestLoopHook):
    pass


def _numeric(results: dict) -> dict:
    """The results a CSV cell or a log line can hold."""
    return {k: v for k, v in results.items()
            if isinstance(v, (int, float, np.floating, np.integer))}


class ConsoleTestLogHook(TestLoopHook):
    def __init__(self):
        self._t0 = None
        self._subject_t0 = None

    def on_startup(self, loop):
        self._t0 = self._subject_t0 = time.time()
        logging.info("test run %s (%s)", loop.test_id, loop.test_dir)

    def on_test_subject_end(self, loop, subject, subject_data, results):
        dt = time.time() - self._subject_t0
        self._subject_t0 = time.time()
        stats = " ".join(f"{k}={float(v):.4f}"
                         for k, v in _numeric(results).items())
        logging.info("  %s %s (%.2fs)", subject, stats, dt)

    def on_test_end(self, loop, subject_results):
        logging.info("test done in %.1fs (%d subjects)",
                     time.time() - self._t0, len(subject_results))


class WriteTestMetricsCsvHook(TestLoopHook):
    """metrics.csv: a row per subject, the numeric results sorted by name."""

    def __init__(self, file_path: str):
        self.file_path = file_path
        self._rows = []
        self._header = None

    def on_test_subject_end(self, loop, subject, subject_data, results):
        numeric = _numeric(results)
        if self._header is None:
            self._header = ["subject"] + sorted(numeric.keys())
        self._rows.append([subject] + [numeric.get(k) for k in self._header[1:]])

    def on_test_end(self, loop, subject_results):
        with open(self.file_path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(self._header or ["subject"])
            writer.writerows(self._rows)

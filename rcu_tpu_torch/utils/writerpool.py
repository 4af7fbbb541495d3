"""Background artifact writer pool with an explicit flush
(``rcu_tpu.utils.writerpool``, copied).

A bounded thread pool whose ``flush()`` the test loop calls at its end:
it waits for every pending write and then re-raises the first failure, so
that a failed NIfTI write surfaces instead of dying with its thread.
"""
from __future__ import annotations

import concurrent.futures
import threading


class WriterPool:
    def __init__(self, max_workers: int = 4):
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=max_workers)
        self._futures = []
        self._lock = threading.Lock()

    def submit(self, fn, *args, **kwargs):
        fut = self._executor.submit(fn, *args, **kwargs)
        with self._lock:
            self._futures.append(fut)
        return fut

    def flush(self):
        """Wait for ALL pending writes to finish, then re-raise the first
        failure. Waiting first matters: an early failure must not leave
        still-running writes untracked while the caller tears down."""
        with self._lock:
            futures, self._futures = self._futures, []
        if not futures:
            return
        concurrent.futures.wait(futures)
        for fut in futures:
            fut.result()

    def shutdown(self):
        try:
            self.flush()
        finally:
            self._executor.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

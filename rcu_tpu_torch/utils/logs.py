"""Logging to stdout and to the run's log file (``rcu_tpu.utils.logs``,
copied)."""
from __future__ import annotations

import logging
import os
import sys


def setup_logging(log_dir: str = None, filename: str = "log.txt",
                  level=logging.INFO):
    root = logging.getLogger()
    root.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler) and h.stream is sys.stdout
               for h in root.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        root.addHandler(sh)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, filename)
        if not any(isinstance(h, logging.FileHandler)
                   and getattr(h, "baseFilename", None) == os.path.abspath(path)
                   for h in root.handlers):
            # a log file belongs to ONE run: drop file handlers installed by
            # earlier runs in this process, or every later run's records
            # would also append into every earlier run's log.txt
            for h in [h for h in root.handlers
                      if isinstance(h, logging.FileHandler)
                      and getattr(h, "_rcu_run_log", False)]:
                root.removeHandler(h)
                h.close()
            fh = logging.FileHandler(path)
            fh._rcu_run_log = True
            fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
            root.addHandler(fh)

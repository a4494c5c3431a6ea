"""Stdout tee logger (rebuild of utils/util.py:63-76).

Installed as ``sys.stdout = Logger(logfile)`` by the eval CLI, mirroring
test_rpnet.py:103, so every per-episode line lands in ``out_dir/log_eval``.
The port's copy of ``rpnet_tpu/utils/logger.py``, plus :meth:`close`.
"""

from __future__ import annotations

import sys


class Logger:
    def __init__(self, logfile: str):
        self.terminal = sys.stdout
        self.log = open(logfile, "a")

    def write(self, message: str):
        self.terminal.write(message)
        self.log.write(message)
        if "\n" in message:   # line-buffered tee so progress is observable
            self.log.flush()

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        self.log.close()

"""Leveled logging with run-time pruning.

Port of ``uammd_tpu/core/logging.py`` (reference: src/System/Log.h:13-35,
System.h:251-256): 15 levels CRITICAL..DEBUG7; a message above the
configured maximum costs one comparison. CRITICAL raises
``SimulationError``, the one error class the port's integrators raise and
its callers catch (System.h:254-256).
"""

from __future__ import annotations

import os
import sys
import time

CRITICAL = 0
ERROR = 1
EXCEPTION = 2
WARNING = 3
MESSAGE = 4
STDERR = 5
STDOUT = 6
DEBUG = 7
# DEBUG1..DEBUG7 -> 8..14
_NAMES = ["CRITICAL", "ERROR", "EXCEPTION", "WARNING", "MESSAGE", "STDERR", "STDOUT",
          "DEBUG"] + [f"DEBUG{i}" for i in range(1, 8)]

MAX_LOG_LEVEL = int(os.environ.get("UAMMD_TPU_LOG_LEVEL", MESSAGE))

_t0 = time.time()


class SimulationError(RuntimeError):
    """A simulation that cannot go on: a critical message, a non-finite
    state after a run."""


def set_level(level: int) -> None:
    global MAX_LOG_LEVEL
    MAX_LOG_LEVEL = level


def log(level: int, msg: str, *args) -> None:
    if level > MAX_LOG_LEVEL:
        return
    text = msg % args if args else msg
    line = f"[{_NAMES[level]}] [{time.time() - _t0:10.3f}] {text}"
    print(line, file=sys.stdout if level == STDOUT else sys.stderr)
    if level == CRITICAL:
        raise SimulationError(text)


def message(msg, *args):
    log(MESSAGE, msg, *args)


def warning(msg, *args):
    log(WARNING, msg, *args)


def error(msg, *args):
    log(ERROR, msg, *args)


def critical(msg, *args):
    log(CRITICAL, msg, *args)


def debug(msg, *args):
    log(DEBUG, msg, *args)


class Timer:
    """Wall timer (reference: System.h:110, the tic-toc idiom)."""

    def __init__(self):
        self.tic()

    def tic(self):
        self._t = time.perf_counter()

    def toc(self) -> float:
        return time.perf_counter() - self._t

"""Runtime utilities: watchdog hang detector, walltime parsing and the
error for what the port has not ported yet.

Counterpart of ``athenak_tpu/utils.py`` (reference:
src/utils/watchdog.cpp:7-40, a pthread that aborts the job if the main
loop stops petting it within the -w window, and the -t hh:mm:ss
clean-stop walltime, main.cpp, driver.cpp:390-394).  A copy of
``parse_walltime`` and ``WatchDog``, kept in the port so that it never
imports the JAX package.
"""

from __future__ import annotations

import os
import sys
import threading
import time


def not_ported(what: str) -> NotImplementedError:
    """The error raised for a feature of the JAX package that the port
    does not have yet."""
    return NotImplementedError(f"{what} is not ported to athenak_tpu_torch "
                               "yet")


def parse_walltime(s: str) -> float:
    """hh:mm:ss (or mm:ss or ss) -> seconds."""
    parts = [float(p) for p in s.split(":")]
    t = 0.0
    for p in parts:
        t = t * 60.0 + p
    return t


class WatchDog:
    """Aborts the process if not petted within ``timeout`` seconds."""

    def __init__(self, timeout: float) -> None:
        self.timeout = timeout
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def pet(self) -> None:
        self._last = time.monotonic()

    def stop(self) -> None:
        self._stop.set()

    def _watch(self) -> None:
        while not self._stop.wait(min(self.timeout / 4.0, 5.0)):
            if time.monotonic() - self._last > self.timeout:
                print(f"### WATCHDOG: main loop hung for more than "
                      f"{self.timeout} s, aborting", file=sys.stderr,
                      flush=True)
                os._exit(66)

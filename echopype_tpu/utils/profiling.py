"""Per-stage timing and JAX profiler hooks.

The reference has no in-repo observability beyond logging (SURVEY.md §5);
this module adds the device-side equivalents: a stage timer that aggregates
wall/device time per pipeline stage, and optional JAX profiler traces.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

from .log import _init_logger

logger = _init_logger(__name__)

__all__ = ["StageTimer", "trace"]


class StageTimer:
    """Accumulates wall-clock per named pipeline stage.

    >>> timer = StageTimer()
    >>> with timer.stage("calibrate"):
    ...     ...
    >>> timer.report()
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a stage; pass ``sync=jax.block_until_ready``-able outputs via
        the returned list to include device time."""
        holder = []
        t0 = time.perf_counter()
        try:
            yield holder
        finally:
            if holder:
                import jax

                jax.block_until_ready(holder)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self, log=True) -> dict:
        out = {
            name: {"total_s": round(t, 4), "count": self.counts[name]}
            for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }
        if log:
            for name, row in out.items():
                logger.info("stage %-20s %8.3f s  (%d calls)", name, row["total_s"], row["count"])
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """JAX profiler trace contextmanager (view with TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()

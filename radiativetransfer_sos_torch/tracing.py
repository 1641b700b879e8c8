"""Structured logging + per-stage timers (SURVEY.md §5 observability).

The reference narrates each module into optional ASCII trace files gated by
``-*.Log`` keywords (main log ``src/SOS_PROC.F:1508-1530``, per-module units
88/99, convergence narration ``src/SOS_OS.F:1306-1415``) and ends every log
with ``JOB_STATUS=OK|ERROR`` (``src/SOS_ABS_MAIN.F:2527,3077``).  Here the
equivalent is one structured tracer: named stage timers, key/value events,
and the same JOB_STATUS trailer — plus machine-readable timings for the
performance harness.  Copy of the JAX package's ``tracing.py``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Optional

logger = logging.getLogger("radiativetransfer_sos_torch")


class Trace:
    """Collects stage timings and events for one pipeline run."""

    def __init__(self, logfile: Optional[str] = None, echo: bool = False):
        self.timings: dict[str, float] = {}
        self.events: list[tuple[str, dict]] = []
        self._fh = open(logfile, "w") if logfile else None
        self._echo = echo
        self._t0 = time.perf_counter()

    def _emit(self, line: str) -> None:
        if self._fh:
            self._fh.write(line + "\n")
        if self._echo:
            logger.info(line)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Timer context for one pipeline stage (angles, aerosols, ...)."""
        t = time.perf_counter()
        self._emit(f"--> {name}")
        try:
            yield self
        finally:
            dt = time.perf_counter() - t
            self.timings[name] = self.timings.get(name, 0.0) + dt
            self._emit(f"<-- {name} {dt:.3f}s")

    def event(self, name: str, **fields) -> None:
        self.events.append((name, fields))
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        self._emit(f"    {name}: {kv}")

    def close(self, ok: bool = True) -> None:
        total = time.perf_counter() - self._t0
        self._emit(f"total {total:.3f}s")
        self._emit("JOB_STATUS=OK" if ok else "JOB_STATUS=ERROR")
        if self._fh:
            self._fh.close()
            self._fh = None


class NullTrace(Trace):
    """No-op tracer (still accumulates timings — they are nearly free)."""

    def __init__(self):
        super().__init__(logfile=None, echo=False)

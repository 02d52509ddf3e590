"""Logging & timing: leveled logger, file sink, heartbeat, phase timers.

Counterpart of the reference's logging stack (ref: SKIRT/fitsio-free logging
classes — Log.hpp:89-103 five-second progress heartbeat and level filtering,
FileLog.hpp file sink next to the outputs, TimeLogger.hpp:22 scoped phase
timers with start/finish lines, ProcessManager rank prefixes). Host-side
Python: the TPU engine stays pure; the host loop logs between jitted steps.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import sys
import time


LEVELS = {"info": 20, "warning": 30, "error": 40, "success": 25}


class Log:
    """Leveled logger with optional file sink.

    (ref: Log.hpp verbosity levels + FileLog; the reference writes
    `<prefix>_log.txt` next to the simulation outputs,
    SkirtCommandLineHandler.cpp doSimulation.)
    """

    def __init__(self, level: str = "info", path: str | None = None,
                 stream=None, rank: int | None = None):
        self.level = LEVELS.get(level, 20)
        self.stream = stream if stream is not None else sys.stdout
        self.rank = rank
        self._file = open(path, "a", encoding="utf-8") if path else None
        # first heartbeat only after a full interval of real work
        self._last_heartbeat = time.monotonic()

    # ------------------------------------------------------------- plumbing

    def close(self):
        if self._file:
            self._file.close()
            self._file = None

    def _emit(self, level: str, msg: str):
        if LEVELS[level] < self.level:
            return
        stamp = datetime.datetime.now().strftime("%d/%m/%Y %H:%M:%S.%f")[:-3]
        tag = {"info": "  ", "success": "- ", "warning": "! ",
               "error": "* "}[level]
        prefix = f"[P{self.rank:03d}] " if self.rank is not None else ""
        line = f"{stamp} {tag}{prefix}{msg}"
        print(line, file=self.stream)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()

    # --------------------------------------------------------------- levels

    def info(self, msg: str):
        self._emit("info", msg)

    def success(self, msg: str):
        self._emit("success", msg)

    def warning(self, msg: str):
        self._emit("warning", msg)

    def error(self, msg: str):
        self._emit("error", msg)

    # ------------------------------------------------------------ heartbeat

    def progress(self, done: int, total: int, what: str = "photon packets",
                 min_interval: float = 5.0):
        """Rate-limited progress line (ref: Log::infoIfElapsed —
        at most one line per five seconds, Log.hpp:89-103). The final
        (done == total) line is emitted only if an intermediate line was,
        so short segments stay silent."""
        now = time.monotonic()
        if done >= total:
            if getattr(self, "_progress_live", False):
                self._progress_live = False
                self.info(f"Launched {what}: 100.0% ({done:,}/{total:,})")
            return
        if now - self._last_heartbeat < min_interval:
            return
        self._last_heartbeat = now
        self._progress_live = True
        pct = 100.0 * done / max(total, 1)
        self.info(f"Launched {what}: {pct:.1f}% ({done:,}/{total:,})")

    # ---------------------------------------------------------- phase timer

    @contextlib.contextmanager
    def timed(self, phase: str):
        """Scoped phase timer (ref: TimeLogger.hpp:22 — 'Starting x...' /
        'Finished x in n s.')."""
        self.info(f"Starting {phase}...")
        t0 = time.monotonic()
        try:
            yield
        except Exception:
            self.error(f"Aborted {phase} after "
                       f"{time.monotonic() - t0:.1f} s")
            raise
        self.success(f"Finished {phase} in {time.monotonic() - t0:.1f} s.")

    # ------------------------------------------------------- memory report

    def memory(self, note: str = ""):
        """Peak RSS report (ref: MemoryLogger / the reference's final
        'Peak memory usage' line)."""
        try:
            import resource
            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            self.info(f"Peak host memory: {peak / 1e6:.2f} GB {note}")
        except Exception:
            pass


_default: Log | None = None


def default() -> Log:
    """Process-wide logger (stdout only until configure() is called)."""
    global _default
    if _default is None:
        _default = Log(level=os.environ.get("SKIRT9_TPU_LOGLEVEL", "info"))
    return _default


def configure(prefix: str, outdir: str = ".", level: str = "info") -> Log:
    """Install a file-backed default logger: `<outdir>/<prefix>_log.txt`
    (ref: FileLog naming)."""
    global _default
    if _default is not None:
        _default.close()
    _default = Log(level=level,
                   path=os.path.join(outdir, f"{prefix}_log.txt"))
    return _default

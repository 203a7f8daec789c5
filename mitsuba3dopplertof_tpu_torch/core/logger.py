"""Leveled logging + progress reporting + profiler hooks.

Analog of the reference's observability stack (copied from the JAX
package's ``core/logger.py``; only the profiler hooks differ):

  * Logger/Appender/Formatter (reference src/core/logger.cpp,
    appender.cpp, formatter.cpp): leveled console logging with the
    DefaultFormatter's elapsed-time prefix.
  * ProgressReporter (reference src/core/progress.cpp): console bar used
    by the render orchestration (reference integrator.cpp:170,216-219).
  * Profiler phases (reference include/mitsuba/core/profiler.h:20-49):
    `profile_phase` wraps torch.profiler.record_function so phases
    (RayIntersect / RayTest / FilmPut...) appear in traces captured with
    `trace_to` (a torch.profiler Chrome trace, viewable in Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

TRACE, DEBUG, INFO, WARN, ERROR = 0, 1, 2, 3, 4
_LEVEL_NAMES = {TRACE: "TRACE", DEBUG: "DEBUG", INFO: "INFO",
                WARN: "WARN", ERROR: "ERROR"}
_NAME_LEVELS = {v: k for k, v in _LEVEL_NAMES.items()}

_start_time = time.time()
_log_level = _NAME_LEVELS.get(os.environ.get("MI_LOG_LEVEL", "WARN").upper(),
                              WARN)
_appenders = []


def set_log_level(level) -> None:
    """Set the global log level (int constant or name string)."""
    global _log_level
    _log_level = (_NAME_LEVELS[level.upper()] if isinstance(level, str)
                  else int(level))


def log_level() -> int:
    return _log_level


def add_appender(fn) -> None:
    """Register an extra sink ``fn(level:int, msg:str)`` (reference
    Appender). The default console appender always stays active."""
    _appenders.append(fn)


def log(level: int, msg: str, *args) -> None:
    """Leveled log with the DefaultFormatter-style prefix
    ``<elapsed> <LEVEL> [mitsuba] msg`` (reference formatter.cpp)."""
    if level < _log_level:
        return
    if args:
        msg = msg % args
    dt = time.time() - _start_time
    m, s = divmod(dt, 60.0)
    line = (f"{int(m):03d}:{s:06.3f} {_LEVEL_NAMES.get(level, '?'):5s} "
            f"[mitsuba] {msg}")
    print(line, file=sys.stderr if level >= WARN else sys.stdout,
          flush=True)
    for fn in _appenders:
        fn(level, msg)


class ProgressReporter:
    """Console progress bar (reference src/core/progress.cpp): updates at
    most every ``min_interval`` seconds, shows fraction + elapsed + ETA."""

    def __init__(self, label: str, enabled: bool = True,
                 min_interval: float = 0.25):
        self.label = label
        self.enabled = enabled and sys.stdout.isatty() or (
            enabled and os.environ.get("MI_FORCE_PROGRESS"))
        self.t0 = time.time()
        self.last = 0.0
        self.min_interval = min_interval

    def update(self, frac: float) -> None:
        if not self.enabled:
            return
        now = time.time()
        if frac < 1.0 and now - self.last < self.min_interval:
            return
        self.last = now
        frac = min(max(frac, 0.0), 1.0)
        elapsed = now - self.t0
        eta = elapsed / max(frac, 1e-9) * (1.0 - frac)
        width = 40
        filled = int(width * frac)
        bar = "=" * filled + (">" if filled < width else "") + \
              " " * max(width - filled - 1, 0)
        sys.stdout.write(f"\r{self.label} [{bar}] {100*frac:5.1f}% "
                         f"({elapsed:.1f}s, ETA {eta:.1f}s) ")
        if frac >= 1.0:
            sys.stdout.write("\n")
        sys.stdout.flush()


def profile_phase(name: str):
    """Named profiler phase (reference ScopedPhase, profiler.h:20-49):
    a torch.profiler range; negligible cost when not tracing."""
    import torch
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace_to(path: str):
    """Capture a CPU + CUDA trace as a Chrome trace file at ``path``:

        with mi.trace_to("trace.json"):
            mi.render(scene)

    (reference: VTune/NSight forwarding, CMakeLists.txt:41-42)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
    log(INFO, "profiler trace written to %s", path)


__all__ = ["TRACE", "DEBUG", "INFO", "WARN", "ERROR", "set_log_level",
           "log_level", "log", "add_appender", "ProgressReporter",
           "profile_phase", "trace_to"]

"""Trace storage and analytics of the PyTorch port.

Copies of ``repro.trace``'s modules that are free of JAX:

* ``store.py`` — :class:`TraceStore`, the bounded-memory ``EventLog``
  backend (in-memory ring + append-only JSONL spill + seekable reader);
  pass it as ``trace=`` to any pool.  Its spill file is the write-ahead
  log that ``run_irregular(..., wal=True)`` journals and
  ``resume_from=`` replays (``repro_torch.chaos.recovery``).  The JSONL
  is the reference package's, so a journal written by either package
  resumes in the other.
* ``analytics.py`` — the incremental concurrency/utilization curves that
  ``core.telemetry.EventLog`` keeps up to date.

Replay and calibration (``replay.py``, ``calibrate.py``) are not ported
yet.
"""
from .analytics import TraceAnalytics, render_concurrency_figure
from .store import (ShardedTraceStore, TraceReader, TraceStore,
                    event_from_dict, event_to_dict, iter_trace_events,
                    read_trace)

__all__ = ["TraceAnalytics", "render_concurrency_figure",
           "TraceStore", "ShardedTraceStore", "TraceReader", "read_trace",
           "event_to_dict", "event_from_dict", "iter_trace_events"]

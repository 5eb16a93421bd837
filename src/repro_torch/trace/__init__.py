"""Trace storage, analytics, replay and calibration of the PyTorch port.

Copies of ``repro.trace``'s modules, free of JAX and host-only (none of
them touches a tensor or launches a kernel):

* ``store.py`` — :class:`TraceStore`, the bounded-memory ``EventLog``
  backend (in-memory ring + append-only JSONL spill + seekable reader);
  pass it as ``trace=`` to any pool.  Its spill file is the write-ahead
  log that ``run_irregular(..., wal=True)`` journals and
  ``resume_from=`` replays (``repro_torch.chaos.recovery``).  The JSONL
  is the reference package's, so a journal written by either package
  resumes in the other.
* ``analytics.py`` — the incremental concurrency/utilization curves that
  ``core.telemetry.EventLog`` keeps up to date, and the Fig. 4 artifact
  set (:func:`render_concurrency_figure`: CSV and ASCII always, a PNG
  when matplotlib is importable).
* ``replay.py`` — reconstruct a recorded run's task-arrival/duration
  structure (:func:`extract_workload`) and re-execute it on ``SimPool``
  under another provider or autoscale policy (:func:`replay`,
  :func:`what_if`).  The replayed bodies are virtual: a replay runs no
  task body, so it launches nothing on the card.
* ``calibrate.py`` — :func:`fit_provider`: a ``ProviderModel`` (cold and
  warm overhead, burst, ramp, keep-alive bound) fitted to a pool's own
  timeline.

A run recorded on the card replays and calibrates exactly as one
recorded on the CPU: a sim pool's timestamps are virtual, a function of
the task results alone.
"""
from .analytics import TraceAnalytics, render_concurrency_figure
from .calibrate import ProviderFit, calibrate, fit_provider
from .replay import (ReplayTask, ReplayWorkload, extract_workload,
                     replay, replay_spec, what_if)
from .store import (ShardedTraceStore, TraceReader, TraceStore,
                    event_from_dict, event_to_dict, iter_trace_events,
                    read_trace)

__all__ = [
    "TraceStore", "ShardedTraceStore", "TraceReader", "read_trace",
    "event_to_dict", "event_from_dict", "iter_trace_events",
    "TraceAnalytics", "render_concurrency_figure",
    "ReplayTask", "ReplayWorkload", "extract_workload", "replay_spec",
    "replay", "what_if",
    "ProviderFit", "calibrate", "fit_provider",
]

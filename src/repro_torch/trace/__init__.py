"""Trace analytics of the PyTorch port.

``analytics.py`` is a copy of ``repro.trace.analytics``: the incremental
concurrency/utilization curves that ``core.telemetry.EventLog`` keeps up
to date (without it every query falls back to a sorted recompute).  The
rest of ``repro.trace`` (stores, replay, calibration) is ported later.
"""
from .analytics import TraceAnalytics, render_concurrency_figure

__all__ = ["TraceAnalytics", "render_concurrency_figure"]

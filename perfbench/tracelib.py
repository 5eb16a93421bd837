"""The device's timeline under ``torch.profiler``, on the host's clock.

After the idea of ``device_timeline`` in the repository's ``chip_smoke.py``
(sound, copied): device activity only, so the host's pace is disturbed
least; the raw device records, not the profiler's event tree; the union
of every kernel, copy and fill, so that work on concurrent streams counts
once.  Added here: marker kernels at both ends tie the profiler's clock
to ``time.monotonic``, so that the device's idle gaps can be set beside
the benchmark's own host spans.
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["DeviceTrace", "union_s", "merge", "gaps", "short_name",
           "covered"]

Span = Tuple[float, float]
_MARK = "spin_kernel"


def merge(spans: Sequence[Span]) -> List[Span]:
    """The disjoint union of ``spans``, sorted."""
    out: List[Span] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def union_s(spans: Sequence[Span], lo: float = -np.inf,
            hi: float = np.inf) -> float:
    """Seconds covered by ``spans`` within [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merge(spans))


def gaps(spans: Sequence[Span], lo: float, hi: float) -> List[Span]:
    """The intervals of [lo, hi] that no span covers."""
    out, at = [], lo
    for a, b in merge(spans):
        if b <= lo:
            continue
        if a >= hi:
            break
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


def covered(points: np.ndarray, spans: Sequence[Span]) -> np.ndarray:
    """Whether each point lies inside one of ``spans``."""
    u = merge(spans)
    if not u:
        return np.zeros(len(points), bool)
    starts = np.array([a for a, _ in u])
    ends = np.array([b for _, b in u])
    i = np.searchsorted(starts, points, side="right") - 1
    return (i >= 0) & (points <= ends[np.maximum(i, 0)])


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and signature; other device operations (copies, fills) as
    the profiler names them."""
    bare = name.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void )?([A-Za-z_][\w:]*)[<(]", bare)
    return m.group(1).split("::")[-1] if m else name


class DeviceTrace:
    """Profile the device between :meth:`start` and :meth:`stop`.

    ``events`` are ``(name, start, end)`` with times in seconds of
    ``time.monotonic``: the profiler's device times shifted by the offset
    that a marker kernel, launched on an idle device after :meth:`start`
    and before :meth:`stop`, shows.  ``offsets`` holds one offset a marker
    found; the two agree to some microseconds.
    """

    def __init__(self, device) -> None:
        self.device = device
        self.events: List[Tuple[str, float, float]] = []
        self.offsets: List[float] = []
        self._prof = None
        self._marks: List[int] = []

    def _mark(self) -> None:
        import torch
        torch.cuda.synchronize(self.device)
        self._marks.append(time.monotonic_ns())
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark()

    def stop(self) -> None:
        from torch.autograd import DeviceType
        self._mark()
        self._prof.__exit__(None, None, None)
        raw = [e for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        self._prof = None
        marks = sorted(e.start_ns() for e in raw if _MARK in e.name())
        rest = [e for e in raw if _MARK not in e.name()]
        if len(marks) == 2:
            pairs = list(zip(marks, self._marks))
        elif len(marks) == 1 and rest:
            # one marker lost (seen once in a 51 s UTS run): the start one
            # if it precedes every other device record, else the end one
            first = min(e.start_ns() for e in rest)
            pairs = [(marks[0], self._marks[0 if marks[0] <= first else 1])]
        else:
            raise RuntimeError(
                f"the profiler showed {len(marks)} marker kernels, want 2")
        self.offsets = [(m - h) / 1e9 for m, h in pairs]
        off = self.offsets[0]
        self.events = [(e.name(), e.start_ns() / 1e9 - off,
                        e.end_ns() / 1e9 - off) for e in rest]

    def spans(self, name: Optional[str] = None) -> List[Span]:
        """Device intervals, of the kernels whose name holds ``name``."""
        return [(a, b) for n, a, b in self.events
                if name is None or name in n]

    def by_name(self) -> Dict[str, float]:
        """Seconds of device time by short kernel name."""
        out: Dict[str, float] = {}
        for n, a, b in self.events:
            k = short_name(n)
            out[k] = out.get(k, 0.0) + (b - a)
        return out

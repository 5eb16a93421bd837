"""Master crash recovery from the trace spill — the WAL was already there.

A killed *worker* is cheap: tasks are stateless, the executor retries.
A killed *master* used to lose the run — the frontier and the partial
accumulator live only in driver memory.  But every pool already
journals its timeline, and with ``run_irregular(..., wal=True)`` the
driver additionally lands one ``folded`` event per settled item — the
item's canonical encoding plus its encoded result, emitted AFTER the
fold is applied and BEFORE any children dispatch (write-ahead order).
That makes the spilled :class:`~repro_torch.trace.store.TraceStore` JSONL a
complete write-ahead log, and recovery pure journal replay:

* **partial accumulator** = ``spec.init()`` folded with ``spec.reduce``
  over the journal's decoded results, in journal order;
* **expected items** = ``spec.seed(...)`` plus ``spec.split`` of every
  journaled result — every item the run would ever have known about;
* **pending frontier** = expected minus folded (a multiset diff on the
  items' canonical encodings — UTS bags repeat, so keys are counted).

``run_irregular(pool, spec, resume_from=trace)`` then seeds from the
recovered frontier and folds into the recovered partial; because the
paper workloads' (reduce, merge, finalize) triples are
order-insensitive, the resumed output is bit-identical to the unkilled
run.  The spec only needs three codec hooks (``encode_item``,
``encode_result``, ``decode_result``): items are never decoded — their
encoding is just the matching key — so only results must round-trip
exactly.

Segment checkpointing (``run_irregular(..., checkpoint_every=N)``)
bounds the replay: the driver periodically journals a ``checkpoint``
event carrying the encoded accumulator and the pending multiset at a
consistent cut, and recovery then restarts from the LAST checkpoint
and folds only the journal tail past it — a 10⁵-event journal recovers
in O(tail), not O(journal).  Checkpoint restart needs two more codecs
(``decode_state``, ``decode_item``) because pending items are
reconstructed from their encodings rather than re-derived from
seed/split.
"""
from __future__ import annotations

import dataclasses
import json
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, List, Optional

from ..core.adaptive import TaskShape
from ..core.telemetry import CHECKPOINT, FOLDED

__all__ = ["FrontierRecovery", "recover_frontier", "MasterKilledError",
           "kill_master_after"]


class MasterKilledError(RuntimeError):
    """The master (driver) process died mid-run — test/injection only;
    a real master crash just disappears."""


def canonical_key(encoded: Any) -> str:
    """Stable string key for an encoded item (order-normalized JSON)."""
    return json.dumps(encoded, sort_keys=True, separators=(",", ":"))


@dataclass
class FrontierRecovery:
    """What :func:`recover_frontier` reconstructed from a WAL.

    Iterable as ``(pending, partial)`` for tuple unpacking."""

    #: un-folded work items, in discovery order (seeds first, then each
    #: journaled result's children in journal order; when recovering
    #: from a checkpoint, the checkpoint's decoded pending items first)
    pending: List[Any] = field(default_factory=list)
    #: accumulator state after replaying every journaled fold
    partial: Any = None
    #: journaled folds replayed — with a checkpoint, only the tail past
    #: it (the whole point of segment checkpointing)
    folded: int = 0
    #: True when recovery restarted from a ``checkpoint`` event instead
    #: of folding the entire journal
    checkpointed: bool = False

    def __iter__(self):
        return iter((self.pending, self.partial))


def _require_codecs(spec: Any) -> None:
    missing = [name for name in
               ("encode_item", "encode_result", "decode_result")
               if getattr(spec, name, None) is None]
    if missing:
        raise ValueError(
            f"{spec.name}: recovery needs WAL codecs on the spec "
            f"(missing {', '.join(missing)})")


def recover_frontier(
    trace: Any,
    spec: Any,
    *,
    shape: Optional[TaskShape] = None,
    initial_shape: Optional[TaskShape] = None,
) -> FrontierRecovery:
    """Reconstruct ``(pending_items, partial_accumulator)`` from a
    WAL-bearing trace.

    ``trace`` is anything event-shaped: a live ``TraceStore`` /
    ``ShardedTraceStore`` / ``EventLog``, a :class:`TraceReader`, a
    spill-file path, or a raw event iterable.  ``shape`` /
    ``initial_shape`` must match the killed run's (they determine
    ``seed`` and ``split`` fan-out); both default to ``spec.shape``.
    """
    from ..trace.store import iter_trace_events
    _require_codecs(spec)
    shape = shape or spec.shape
    seed_shape = initial_shape or shape

    if isinstance(trace, str):
        from ..trace.store import read_trace
        trace = read_trace(trace)

    # a payload is one {"item", "result"} entry, or — for fused batch
    # chunks / sharded gather waves, journaled atomically — a
    # {"batch": [entry, ...]} of them.  A ``checkpoint`` event resets
    # the collection: only the tail past the LAST checkpoint must be
    # replayed (segment checkpointing — the checkpoint carries the
    # encoded accumulator and the pending multiset at its cut).
    entries: List[dict] = []
    ckpt: Optional[dict] = None
    for ev in iter_trace_events(trace):
        if ev.payload is None:
            continue
        if ev.kind == CHECKPOINT:
            ckpt = ev.payload
            entries = []
        elif ev.kind == FOLDED:
            entries.extend(ev.payload.get("batch", [ev.payload])
                           if isinstance(ev.payload, dict) else ())

    if ckpt is not None:
        missing = [n for n in ("decode_state", "decode_item")
                   if getattr(spec, n, None) is None]
        if missing:
            raise ValueError(
                f"{spec.name}: the WAL carries a checkpoint but the "
                f"spec lacks {', '.join(missing)} — cannot restart "
                f"from it")
        partial = spec.decode_state(ckpt["state"])
        base = [spec.decode_item(e) for e in ckpt["pending"]]
    else:
        partial = spec.init()
        base = None

    # replay the journal tail: fold results in order, collect keys
    folded_keys: Counter = Counter()
    results = []
    for p in entries:
        folded_keys[canonical_key(p["item"])] += 1
        r = spec.decode_result(p["result"])
        results.append(r)
        partial = spec.reduce(partial, r)

    # every item the run knew about past the cut: the checkpoint's
    # pending multiset (or, without one, the seeds) + tail children
    expected: List[Any] = (base if base is not None
                           else list(spec.seed(seed_shape)))
    for r in results:
        expected.extend(spec.split(r, shape))

    pending: List[Any] = []
    for item in expected:
        k = canonical_key(spec.encode_item(item))
        if folded_keys.get(k, 0) > 0:
            folded_keys[k] -= 1
        else:
            pending.append(item)

    leftover = sum(folded_keys.values())
    if leftover:
        raise ValueError(
            f"{spec.name}: WAL journals {leftover} fold(s) for items the "
            f"replayed seed/split never produced — shape/initial_shape "
            f"probably differ from the killed run's")
    return FrontierRecovery(pending=pending, partial=partial,
                            folded=len(entries),
                            checkpointed=ckpt is not None)


def kill_master_after(spec: Any, n_folds: int, *,
                      kill_on_steal: Optional[int] = None) -> Any:
    """Test harness: a copy of ``spec`` whose master dies (raises
    :class:`MasterKilledError`) when it attempts fold ``n_folds + 1``.

    The first ``n_folds`` folds complete normally — and, under
    ``wal=True``, are journaled — so a run driven with the returned
    spec leaves exactly the WAL a real crash at that frontier depth
    would.  The counter is shared across shards (the sharded driver
    settles on one thread), so ``shards=K`` dies at the same global
    depth as ``shards=1``.

    ``kill_on_steal=N`` additionally arms the *sharded* driver to die
    on its N-th successful work-steal — mid-steal, after the transfer
    but before the stolen items dispatch — exercising the crash window
    fold-ordinal kills can never reach (steals move items between
    in-memory frontiers without journaling, so the WAL left behind is
    exactly a real mid-steal crash's).  Whichever trigger fires first
    wins; pass a large ``n_folds`` to isolate the steal path.
    """
    inner = spec.reduce
    count = [0]

    def dying_reduce(state: Any, result: Any) -> Any:
        if count[0] >= n_folds:
            raise MasterKilledError(
                f"{spec.name}: injected master kill after "
                f"{n_folds} folds")
        count[0] += 1
        return inner(state, result)

    if kill_on_steal is not None:
        # carried as a function attribute: specs are frozen dataclasses
        # and the sharded driver already receives ``reduce`` — it reads
        # the threshold back via getattr (see _run_sharded)
        dying_reduce._repro_kill_on_steal = kill_on_steal
    return dataclasses.replace(spec, reduce=dying_reduce)

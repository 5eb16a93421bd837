"""Per-device cost of one step, counted op by op as it runs.

Counterpart of ``repro.benchlib.hlo_analysis``.  The reference reads the
optimized HLO of a compiled step; the port has no HLO, so
:func:`analyze_step` runs the step under a ``TorchDispatchMode`` and counts
every op that reaches the dispatcher on the step's device type (a card's,
or the dry run's ``meta``).  It counts per device: under a mesh each
process runs its own blocks, so every shape it sees is local.  The rules
are the reference's:

  flops     2*M*N*K for the products (``torch.utils.flop_counter``'s
            formulas), 1 an output element for every other op that is
            neither a view nor an allocation; transcendentals (exp, log,
            tanh, rsqrt, sqrt, pow, sigmoid, sin, cos, expm1) counted
            apart too, as ``_TRANS_OPS`` does
  bytes     input + output bytes of each op; views and allocations cost
            0; an in-place write into a slice or an index of a larger
            tensor (``copy_`` into a view, ``index_copy_``, ``index_put_``,
            ``scatter_``, ...) costs twice its update (and indices), as a
            dynamic-update-slice or scatter does there
  coll      each ``c10d`` op by kind, with the reference's ring factors:
            all-reduce 2x result, all-gather result, reduce-scatter
            operand, all-to-all and permute result; and the link its group
            crosses (``benchlib.link_class``)
  kernels   each hand-written kernel op by its ``work`` formula
            (``KernelOp.work``) and by name, as its CUDA body launches it
            (or, on meta or fake operands, traces it without a launch);
            the counter never descends into a plain version's ops

Peak live bytes: every storage the step's tensors live in is counted
once, from the op that makes it until the last tensor on it goes (weak
references), with the arguments' storages live throughout.

The per-op facts are kept (:attr:`StepCost.ops`, one record per distinct
op and shapes, with its count), and :func:`cost_from_ops` applies the
rules to them, so the rules can change without tracing again
(``roofline.reanalyze``).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from . import link_class
from ..kernels.dispatch import (get_kernel, in_plain_version,
                                kernel_observers)

__all__ = ["StepCost", "analyze_step", "cost_from_ops",
           "top_bytes_contributors", "collective_bytes", "OP_FIELDS"]

_TRANS_OPS = {"exp", "log", "tanh", "rsqrt", "sqrt", "pow", "sigmoid", "sin",
              "cos", "expm1"}
#: allocations: storage, no work
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided", "empty_permuted"}
#: views the schema does not mark as aliases
_VIEWS = {"_unsafe_view", "_reshape_alias", "lift_fresh", "alias"}
#: in-place writes into an index of their first operand
_INDEX_WRITES = {"index_copy_", "index_put_", "_index_put_impl_",
                 "scatter_", "scatter_add_", "scatter_reduce_", "index_add_",
                 "index_fill_", "masked_scatter_"}
_COLLECTIVES = {
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "_allgather_base_": "all_gather", "allgather_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "allgather_coalesced_": "all_gather",
    "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_": "reduce_scatter",
    "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "alltoall_base_": "all_to_all", "alltoall_": "all_to_all",
    "broadcast_": "collective_permute", "send": "collective_permute",
    "recv_": "collective_permute",
}
#: c10d ops that move no data
_NO_DATA = {"barrier", "monitored_barrier_"}

#: one op record: (name, category, output, input bytes, output bytes,
#: output elements, product flops, update bytes, collective kind, result
#: bytes, operand bytes, link class, group size, kernel flops, kernel bytes)
OP_FIELDS = ("op", "cat", "out", "in_bytes", "out_bytes", "out_elems",
             "product_flops", "update_bytes", "coll", "result_bytes",
             "operand_bytes", "link", "group", "kernel_flops",
             "kernel_bytes")


@dataclass
class StepCost:
    """One step's per-device cost (the reference's ``HloCost`` with the
    port's additions: kernels by name, link bytes by class, memory)."""
    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    collectives: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    link_bytes: float = 0.0
    #: link bytes by the link they cross ("local", "nvlink", "ib")
    link_by_class: Dict[str, float] = field(default_factory=dict)
    #: kernel op name -> calls
    kernels: Dict[str, int] = field(default_factory=dict)
    #: storages live at the step's start (its arguments), and the most
    #: live at once, arguments included
    argument_bytes: int = 0
    peak_bytes: int = 0
    output_bytes: int = 0
    #: the per-op facts: dicts of ``OP_FIELDS`` and their count ``n``
    ops: List[dict] = field(default_factory=list, repr=False)
    #: what the step returned
    result: Any = field(default=None, repr=False, compare=False)


def _ring_link(kind: str, result: float, operand: float) -> float:
    """Link bytes of one collective (the reference's ring factors)."""
    if kind == "all_reduce":
        return 2.0 * result
    if kind == "reduce_scatter":
        return float(operand)
    return float(result)


def cost_from_ops(ops: List[dict]) -> StepCost:
    """The rules (module docstring) applied to per-op records."""
    c = StepCost(ops=list(ops))
    for r in ops:
        n = r["n"]
        cat = r["cat"]
        if cat in ("view", "alloc"):
            continue
        if cat == "kernel":
            c.flops += n * r["kernel_flops"]
            c.bytes += n * r["kernel_bytes"]
            c.kernels[r["op"]] = c.kernels.get(r["op"], 0) + n
        elif cat == "collective":
            kind = r["coll"]
            link = n * _ring_link(kind, r["result_bytes"], r["operand_bytes"])
            c.collectives[kind] = c.collectives.get(kind, 0.0) + link
            c.collective_counts[kind] = c.collective_counts.get(kind, 0) + n
            c.link_bytes += link
            c.link_by_class[r["link"]] = c.link_by_class.get(
                r["link"], 0.0) + link
            c.bytes += n * (r["result_bytes"] + r["operand_bytes"])
        elif cat == "index_write":
            c.bytes += n * 2 * r["update_bytes"]
        else:
            if cat == "product":
                c.flops += n * r["product_flops"]
            else:
                c.flops += n * r["out_elems"]
                if cat == "trans":
                    c.transcendentals += n * r["out_elems"]
            c.bytes += n * (r["in_bytes"] + r["out_bytes"])
    return c


def _tensors(x: Any, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _base_name(func) -> str:
    return func._overloadpacket.__name__


class _Storages:
    """Live storages of one device type: the arguments' (fixed) and the
    step's own (dropped when their weak reference expires)."""

    def __init__(self) -> None:
        self.fixed: Dict[int, int] = {}
        self.live: Dict[int, Tuple[int, StorageWeakRef]] = {}
        self.args = 0
        self.total = 0
        self.peak = 0

    def fix(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st._cdata not in self.fixed:
            self.fixed[st._cdata] = st.nbytes()
            self.args += st.nbytes()
            self.peak = max(self.peak, self.args)

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.fixed:
            return
        old = self.live.get(key)
        if old is not None:
            if not old[1].expired():
                return
            self.total -= old[0]
        nb = st.nbytes()
        self.live[key] = (nb, StorageWeakRef(st))
        self.total += nb
        if self.total + self.args > self.peak:
            self._prune()
            self.peak = max(self.peak, self.total + self.args)

    def _prune(self) -> None:
        dead = [k for k, (_, ref) in self.live.items() if ref.expired()]
        for k in dead:
            self.total -= self.live.pop(k)[0]


class _Counter(TorchDispatchMode):
    """The dispatch mode behind :func:`analyze_step`."""

    def __init__(self, device_type: str) -> None:
        super().__init__()
        self.device_type = device_type
        self.records: Counter = Counter()
        self.mem = _Storages()
        self._links: Dict[str, Tuple[str, int]] = {}

    # -- kernels --------------------------------------------------------------

    def kernel(self, name: str, operands: tuple, static: dict) -> None:
        if in_plain_version():
            return          # a kernel op inside another's plain version
        op = get_kernel(name)
        flops, nbytes = op.work(*operands, **static) if op.work else (0., 0.)
        self.records[(name, "kernel", "", 0, 0, 0, 0, 0, "", 0, 0, "", 0,
                      float(flops), float(nbytes))] += 1

    # -- collectives ----------------------------------------------------------

    def _group(self, args) -> Tuple[str, int]:
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:
                    pg = dist.ProcessGroup.unbox(a)
                except Exception:   # noqa: BLE001 - another script object
                    continue
                key = pg.group_name
                if key not in self._links:
                    ranks = dist.get_process_group_ranks(pg)
                    self._links[key] = (link_class(ranks), len(ranks))
                return self._links[key]
        return "local", 1

    # -- every op -------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args, [])
        _tensors(list(kwargs.values()), ins)
        outs = _tensors(out, [])
        dt = self.device_type
        mine = [t for t in outs if t.device.type == dt]
        for t in mine:
            self.mem.add(t)
        if in_plain_version():
            return out
        if not mine and not any(t.device.type == dt for t in ins):
            return out
        name = _base_name(func)
        if func.namespace == "c10d":
            if name in _NO_DATA:
                return out
            kind = _COLLECTIVES.get(name, "collective_permute")
            result = _tensors(args[0], []) if args else []
            operand = result if kind == "all_reduce" or len(args) < 2 \
                else _tensors(args[1], [])
            link, size = self._group(args)
            rb, ob = _nbytes(result), _nbytes(operand)
            self.records[(str(func), "collective", "", 0, 0, 0, 0, 0, kind,
                          rb, ob, link, size, 0.0, 0.0)] += 1
            return out
        o0 = outs[0] if outs else None
        desc = "" if o0 is None else \
            f"{str(o0.dtype).replace('torch.', '')}{list(o0.shape)}"
        in_b, out_b = _nbytes(ins), _nbytes(outs)
        out_e = sum(t.numel() for t in outs)
        pflops = upd = 0
        if name in _ALLOCS:
            cat = "alloc"
        elif func.is_view or name in _VIEWS or name == "detach":
            cat = "view"
        elif func._overloadpacket in flop_registry:
            cat = "product"
            pflops = int(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        elif name in _INDEX_WRITES or (name == "copy_" and ins and _in_larger(
                ins[0])):
            cat = "index_write"
            upd = _nbytes(ins[1:])
        elif name.rstrip("_") in _TRANS_OPS:
            cat = "trans"
        else:
            cat = "op"
        self.records[(str(func), cat, desc, in_b, out_b, out_e, pflops, upd,
                      "", 0, 0, "", 0, 0.0, 0.0)] += 1
        return out


def _in_larger(t: torch.Tensor) -> bool:
    """Whether ``t`` is a view on part of a larger storage."""
    return t.numel() * t.element_size() < t.untyped_storage().nbytes()


def _step_device_type(args) -> str:
    for t in tree_leaves(args):
        if isinstance(t, torch.Tensor):
            return t.device.type
    return "cpu"


def analyze_step(fn: Callable, *args: Any, device_type: Optional[str] = None,
                 **kwargs: Any) -> StepCost:
    """Run ``fn(*args, **kwargs)`` once and count it (module docstring).
    Ops on the device type of the first tensor among the arguments are
    counted (``device_type`` overrides), others (a CPU copy of a random
    state) are not.  The result is in :attr:`StepCost.result`."""
    dt = device_type or _step_device_type((args, kwargs))
    counter = _Counter(dt)
    for t in tree_leaves((args, kwargs)):
        if isinstance(t, torch.Tensor) and t.device.type == dt:
            counter.mem.fix(t)
    observers = kernel_observers()
    observers.append(counter.kernel)
    try:
        with counter:
            result = fn(*args, **kwargs)
    finally:
        observers.remove(counter.kernel)
    ops = [dict(zip(OP_FIELDS, key), n=n)
           for key, n in counter.records.items()]
    cost = cost_from_ops(ops)
    cost.argument_bytes = counter.mem.args
    cost.peak_bytes = counter.mem.peak
    seen: Dict[int, int] = {}
    for t in tree_leaves(result):
        if isinstance(t, torch.Tensor) and t.device.type == dt:
            st = t.untyped_storage()
            seen.setdefault(st._cdata, st.nbytes())
    cost.output_bytes = sum(seen.values())
    cost.result = result
    return cost


def top_bytes_contributors(cost: StepCost, k: int = 15
                           ) -> List[Tuple[str, float]]:
    """The ops moving the most bytes in all, as (description, bytes): the
    profile view a hypothesis starts from."""
    rows = []
    for r in cost.ops:
        one = cost_from_ops([dict(r, n=1)])
        b = one.bytes * r["n"]
        if b > 0:
            rows.append((f"{r['op']} [{r['cat']}] x{r['n']} {r['out'][:48]}",
                         b))
    rows.sort(key=lambda row: -row[1])
    return rows[:k]


def collective_bytes(cost: StepCost) -> dict:
    """Collective summary (kind -> link bytes per device)."""
    return {"link_bytes": cost.link_bytes,
            "by_kind": dict(cost.collectives),
            "counts": dict(cost.collective_counts),
            "by_link": dict(cost.link_by_class)}

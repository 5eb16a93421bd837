"""Mariani-Silver Mandelbrot rendering on the elastic executor (§4.1.2).

Counterpart of ``repro.algorithms.mariani_silver``.  Recursive adjacency
optimization: evaluate only the border of each rectangle; if every
border pixel has the same dwell, fill the rectangle with it; otherwise
split and recurse, with full per-pixel evaluation at the maximum depth.
``ms_spec``'s ``split`` hook is the nested parallelism, driven by
``run_irregular``.

Task bodies call the ``mandelbrot`` dwell kernel for border strips and
leaf rectangles.  Pixel coordinates are computed in float64 numpy and
cast to float32 exactly as in the reference, then moved to the device;
dwells come back to the host, where the image accumulator is a numpy
int32 array, so images are bit-identical to the reference package's.
On a CUDA device each task body runs on a side stream of its own
(``device.task_stream``): a border strip is a few warps that may iterate
for the whole ``max_dwell``, and concurrent tasks should overlap on the
card rather than queue behind one another.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import TaskShape, WorkSpec
from ..device import DeviceLike, resolve_device, task_stream
from ..kernels.mandelbrot.ops import mandelbrot

__all__ = ["MSParams", "Rect", "Action", "RectResult", "ms_spec",
           "evaluate_rect", "evaluate_rects", "naive_render"]


@dataclass(frozen=True)
class MSParams:
    width: int = 4096
    height: int = 4096
    max_dwell: int = 512          # paper runs 5M; tests use smaller
    x0: float = -2.0
    y0: float = -1.5
    x1: float = 1.0
    y1: float = 1.5
    split: int = 2                # each side halved -> 4 children
    max_depth: int = 5
    initial_subdivision: int = 4  # sd: initial grid of sd x sd rects


@dataclass(frozen=True)
class Rect:
    """Pixel-space rectangle [px0, px1) x [py0, py1) at a nesting depth."""
    px0: int
    py0: int
    px1: int
    py1: int
    depth: int

    @property
    def w(self) -> int:
        return self.px1 - self.px0

    @property
    def h(self) -> int:
        return self.py1 - self.py0


class Action(Enum):
    FILL = "fill"
    SET_DWELL_ARRAY = "set_dwell_array"
    SPLIT = "split"


@dataclass
class RectResult:
    rect: Rect
    action: Action
    dwell_to_fill: int = 0
    dwell_array: Optional[np.ndarray] = None


def _pixel_coords(rect: Rect, p: MSParams) -> Tuple[np.ndarray, np.ndarray]:
    """float32 coordinates of the rect's pixel centers, [h, w] each."""
    sx = (p.x1 - p.x0) / p.width
    sy = (p.y1 - p.y0) / p.height
    xs = p.x0 + (np.arange(rect.px0, rect.px1) + 0.5) * sx
    ys = p.y0 + (np.arange(rect.py0, rect.py1) + 0.5) * sy
    c_im, c_re = np.meshgrid(ys, xs, indexing="ij")
    return c_re.astype(np.float32), c_im.astype(np.float32)


def _border_coords(rect: Rect, p: MSParams) -> Tuple[np.ndarray, np.ndarray]:
    """Flattened coordinates of the rect's border pixels: top row, bottom
    row, left column, right column (the reference's order)."""
    c_re, c_im = _pixel_coords(rect, p)
    bre = np.concatenate([c_re[0, :], c_re[-1, :], c_re[1:-1, 0],
                          c_re[1:-1, -1]])
    bim = np.concatenate([c_im[0, :], c_im[-1, :], c_im[1:-1, 0],
                          c_im[1:-1, -1]])
    return bre, bim


def _dwells(c_re: np.ndarray, c_im: np.ndarray, p: MSParams,
            device: torch.device) -> np.ndarray:
    """Dwells of a [1, n] row or an [h, w] plane, back on the host.

    On the card the copy back waits only for the current stream, which
    in a task body is the task's own (``task_stream``), so the border
    strips of concurrent tasks, which may iterate ``max_dwell`` times,
    run side by side on the card.
    """
    cre, cim = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (c_re, c_im))
    return mandelbrot(cre, cim, p.max_dwell).cpu().numpy()


def _classify(rect: Rect, border: np.ndarray,
              p: MSParams) -> RectResult:
    """FILL / SPLIT / leaf decision from the border dwells; leaf
    rectangles come back with ``dwell_array=None``."""
    if border.size and np.all(border == border[0]):
        return RectResult(rect, Action.FILL, dwell_to_fill=int(border[0]))
    if rect.depth >= p.max_depth or rect.w <= 2 or rect.h <= 2:
        return RectResult(rect, Action.SET_DWELL_ARRAY)
    return RectResult(rect, Action.SPLIT)


def evaluate_rect(rect: Rect, p: MSParams,
                  device: DeviceLike = None) -> RectResult:
    """Task body — paper Listing 3 (``Callable.call``)."""
    device = resolve_device(device)
    with task_stream(device):
        bre, bim = _border_coords(rect, p)
        res = _classify(rect, _dwells(bre[None, :], bim[None, :], p,
                                      device)[0], p)
        if res.action is Action.SET_DWELL_ARRAY:
            res.dwell_array = _dwells(*_pixel_coords(rect, p), p, device)
    return res


def evaluate_rects(rects: List[Rect], p: MSParams,
                   device: DeviceLike = None) -> List[RectResult]:
    """Fused task body: every border strip of the batch goes through ONE
    kernel dispatch (a single [1, sum(border lens)] row), then every
    leaf interior through one more (pixels flattened end to end).  The
    dwell of each pixel is independent of its neighbours, so the
    per-rect results are bit-identical to :func:`evaluate_rect`."""
    if not rects:
        return []
    device = resolve_device(device)
    with task_stream(device):
        borders = [_border_coords(r, p) for r in rects]
        bre = np.concatenate([b[0] for b in borders])[None, :]
        bim = np.concatenate([b[1] for b in borders])[None, :]
        dwells = _dwells(bre, bim, p, device)[0]
        results: List[RectResult] = []
        off = 0
        for rect, (b, _) in zip(rects, borders):
            results.append(_classify(rect, dwells[off:off + b.shape[0]], p))
            off += b.shape[0]
        leaves = [r for r in results if r.action is Action.SET_DWELL_ARRAY]
        if leaves:
            flats = [_pixel_coords(res.rect, p) for res in leaves]
            fre = np.concatenate([f[0].ravel() for f in flats])[None, :]
            fim = np.concatenate([f[1].ravel() for f in flats])[None, :]
            flat_dwell = _dwells(fre, fim, p, device)[0]
            off = 0
            for res in leaves:
                r = res.rect
                res.dwell_array = \
                    flat_dwell[off:off + r.w * r.h].reshape(r.h, r.w)
                off += r.w * r.h
    return results


def _split_rect(rect: Rect, split: int) -> List[Rect]:
    xs = np.linspace(rect.px0, rect.px1, split + 1).astype(int)
    ys = np.linspace(rect.py0, rect.py1, split + 1).astype(int)
    out = []
    for i in range(split):
        for j in range(split):
            if xs[j + 1] > xs[j] and ys[i + 1] > ys[i]:
                out.append(Rect(xs[j], ys[i], xs[j + 1], ys[i + 1],
                                rect.depth + 1))
    return out


def ms_spec(p: MSParams, device: DeviceLike = None) -> WorkSpec:
    """Mariani-Silver as a declarative ``WorkSpec``.

    Work items are pixel rectangles; the master folds FILL /
    SET_DWELL_ARRAY actions into the host image and recurses on SPLIT
    via the ``split`` hook (Listing 3's nested parallelism).  Dwells are
    computed on ``device``."""
    device = resolve_device(device)

    def seed(shape: TaskShape) -> List[Rect]:
        sd = p.initial_subdivision
        xs = np.linspace(0, p.width, sd + 1).astype(int)
        ys = np.linspace(0, p.height, sd + 1).astype(int)
        return [Rect(xs[j], ys[i], xs[j + 1], ys[i + 1], 0)
                for i in range(sd) for j in range(sd)]

    def execute(rect: Rect, shape: TaskShape) -> RectResult:
        return evaluate_rect(rect, p, device)

    def execute_batch(rects: List[Rect],
                      shape: TaskShape) -> List[RectResult]:
        return evaluate_rects(list(rects), p, device)

    def split(res: RectResult, shape: TaskShape) -> List[Rect]:
        if res.action is Action.SPLIT:
            return _split_rect(res.rect, p.split)
        return []

    def init() -> Dict[str, Any]:
        return {"image": np.zeros((p.height, p.width), np.int32),
                "filled": 0, "evaluated": 0}

    def reduce(state: Dict[str, Any], res: RectResult) -> Dict[str, Any]:
        r = res.rect
        if res.action is Action.FILL:
            state["image"][r.py0:r.py1, r.px0:r.px1] = res.dwell_to_fill
            state["filled"] += r.w * r.h
        elif res.action is Action.SET_DWELL_ARRAY:
            state["image"][r.py0:r.py1, r.px0:r.px1] = res.dwell_array
            state["evaluated"] += r.w * r.h
        return state

    def merge(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
        # every rectangle lands on exactly one shard and pixel writes
        # are disjoint, so shard images sum exactly (int32 on zeros)
        return {"image": a["image"] + b["image"],
                "filled": a["filled"] + b["filled"],
                "evaluated": a["evaluated"] + b["evaluated"]}

    # WAL codecs: the reference package's JSON exactly
    def _enc_rect(r: Rect) -> list:
        return [int(r.px0), int(r.py0), int(r.px1), int(r.py1),
                int(r.depth)]

    def encode_result(res: RectResult) -> dict:
        enc: Dict[str, Any] = {"r": _enc_rect(res.rect),
                               "a": res.action.value}
        if res.action is Action.FILL:
            enc["f"] = int(res.dwell_to_fill)
        elif res.action is Action.SET_DWELL_ARRAY:
            enc["w"] = res.dwell_array.tolist()
            enc["dt"] = str(res.dwell_array.dtype)
        return enc

    def decode_result(enc: dict) -> RectResult:
        rect = Rect(*enc["r"])
        action = Action(enc["a"])
        arr = (np.asarray(enc["w"], np.dtype(enc["dt"]))
               if action is Action.SET_DWELL_ARRAY else None)
        return RectResult(rect, action,
                          dwell_to_fill=enc.get("f", 0),
                          dwell_array=arr)

    return WorkSpec(
        name="mariani_silver",
        execute=execute,
        execute_batch=execute_batch,
        seed=seed,
        split=split,
        reduce=reduce,
        init=init,
        merge=merge,
        cost_hint=lambda rect: float(rect.w * rect.h),
        encode_item=_enc_rect,
        encode_result=encode_result,
        decode_result=decode_result,
    )


def naive_render(p: MSParams, device: DeviceLike = None) -> np.ndarray:
    """Escape-time over every pixel — the correctness oracle."""
    device = resolve_device(device)
    full = Rect(0, 0, p.width, p.height, 0)
    return _dwells(*_pixel_coords(full, p), p, device)

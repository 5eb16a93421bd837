"""Roofline of the dry run's records on the H100 (counterpart of
``repro.benchlib.roofline``).

Per cell three lower bounds on one step's time, from its per-device count
(``op_analysis``): compute (flops at ``PEAK_FLOPS``), memory (bytes at
``HBM_BW``) and collective (each collective's link bytes at the rate of
the link its group crosses, ``benchlib.link_bw``; a group of one rank
crosses none); the largest is the dominant term.  The table sets them
beside the useful model flops (6 N D train, 2 N D inference, N the active
parameters), their ratio to the counted flops, and a line on what would
move the dominant term down.  Every figure is reckoned from datasheet
peaks (``benchlib``), not measured.

A record keeps its per-op count list (``<mesh>.ops.jsonl.gz`` beside
``<mesh>.json``); :func:`reanalyze` rebuilds each analysis block from it,
so the counting rules can change without tracing again.

    PYTHONPATH=src python -m repro_torch.benchlib.roofline reanalyze
    PYTHONPATH=src python -m repro_torch.benchlib.roofline table \
        [pod256|pod512] [root] [--mark]
"""
from __future__ import annotations

import glob
import gzip
import json
import os
from typing import List

from . import HBM_BW, PEAK_FLOPS, link_bw
from ..configs import ARCH_IDS, SHAPES, get_config
from .op_analysis import StepCost, cost_from_ops

__all__ = ["RESULTS", "analysis_block", "save_ops", "load_ops",
           "reanalyze", "model_flops", "table", "main"]

RESULTS = os.path.join("results", "dryrun_torch")


def analysis_block(cost: StepCost) -> dict:
    """The reference's analysis keys (and the port's: link bytes by class,
    kernel ops by name) for one counted step."""
    compute_s = cost.flops / PEAK_FLOPS
    memory_s = cost.bytes / HBM_BW
    coll_s = sum(b / link_bw(cls) for cls, b in cost.link_by_class.items()
                 if link_bw(cls))
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", coll_s)), key=lambda kv: kv[1])[0]
    return {
        "flops_per_device": cost.flops,
        "bytes_per_device": cost.bytes,
        "transcendentals": cost.transcendentals,
        "link_bytes": cost.link_bytes,
        "by_kind": dict(cost.collectives),
        "counts": dict(cost.collective_counts),
        "by_link": dict(cost.link_by_class),
        "kernels": dict(cost.kernels),
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
    }


def save_ops(path: str, ops: List[dict]) -> None:
    with gzip.open(path, "wt") as f:
        for r in ops:
            f.write(json.dumps(r) + "\n")


def load_ops(path: str) -> List[dict]:
    with gzip.open(path, "rt") as f:
        return [json.loads(line) for line in f if line.strip()]


def reanalyze(root: str = RESULTS) -> int:
    n = 0
    for jpath in sorted(glob.glob(os.path.join(root, "*", "*", "*.json"))):
        opath = jpath[:-len(".json")] + ".ops.jsonl.gz"
        if not os.path.exists(opath):
            continue
        with open(jpath) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        try:
            rec["analysis"] = analysis_block(cost_from_ops(load_ops(opath)))
        except Exception as e:  # noqa: BLE001
            rec["analysis"] = {"error": str(e)}
        with open(jpath, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
        print(f"reanalyzed {jpath}", flush=True)
    return n


def model_flops(arch: str, shape_name: str, devices: int) -> float:
    """Analytic useful FLOPs per device per step."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        total = 2.0 * n_active * tokens
    return total / devices


_IMPROVE = {
    ("compute",): "near compute roof — gains come from cutting remat "
                  "recompute or masked-out attention blocks",
    ("memory",): "cut HBM traffic: fuse/stream the dominant transient "
                 "(activation carries, dispatch buffers) and shard "
                 "activations over more axes",
    ("collective",): "cut link bytes: reshard to avoid per-layer "
                     "all-reduce/all-gather (SP/FSDP), or overlap with "
                     "compute",
}


def table(root: str = RESULTS, mesh: str = "pod256",
          mark_replicated: bool = False) -> str:
    """The reference's table over ``root``; with ``mark_replicated`` a
    cell whose record lists ``replicated_layers`` gets a † after its
    shape."""
    devices = 256 if mesh == "pod256" else 512
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | "
        "dominant | MODEL_TF/dev | HLO_TF/dev | useful ratio | note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_IDS:
        for shape_name in SHAPES:
            jpath = os.path.join(root, arch, shape_name, f"{mesh}.json")
            if not os.path.exists(jpath):
                continue
            with open(jpath) as f:
                rec = json.load(f)
            if rec.get("status") == "skipped":
                lines.append(f"| {arch} | {shape_name} | — | — | — | "
                             f"skipped | — | — | — | {rec['reason'][:60]} |")
                continue
            a = rec.get("analysis", {})
            if "compute_s" not in a:
                continue
            mark = " †" if mark_replicated and rec.get(
                "replicated_layers") else ""
            mf = model_flops(arch, shape_name, devices)
            ratio = mf / a["flops_per_device"] \
                if a["flops_per_device"] else 0.0
            note = _IMPROVE[(a["dominant"],)]
            lines.append(
                f"| {arch} | {shape_name}{mark} | {a['compute_s']:.4f} | "
                f"{a['memory_s']:.4f} | {a['collective_s']:.4f} | "
                f"{a['dominant']} | {mf/1e12:.2f} | "
                f"{a['flops_per_device']/1e12:.2f} | {ratio:.2f} | "
                f"{note} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("cmd", nargs="?", default="table",
                    choices=("table", "reanalyze"))
    ap.add_argument("mesh", nargs="?", default="pod256",
                    choices=("pod256", "pod512"))
    ap.add_argument("root", nargs="?", default=RESULTS)
    ap.add_argument("--mark", action="store_true",
                    help="a † on the cells that compute layers replicated")
    args = ap.parse_args(argv)
    if args.cmd == "reanalyze":
        print(f"{reanalyze(args.root)} cells reanalyzed")
    else:
        print(table(args.root, mesh=args.mesh, mark_replicated=args.mark))


if __name__ == "__main__":
    main()

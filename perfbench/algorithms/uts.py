"""UTS trees back to back on the pool (``repro_torch.algorithms.uts_spec``).

The k-th tree's root seed comes from the run's seed and k.  Each task's
answer is (count, leftover bag).  The check follows the program from its
own state, since a task's input bag is the leftover of an earlier task,
and covers every task of the run, the tree cut at the window's end too:

* the start: each tree's seed items against the reference's root digest;
* the tasks: a sample of the window's tasks, drawn from the seed, each
  traversed again by the plain reference from a copy of its input bag,
  count and leftover compared exactly;
* the split, which that skips: for every leftover the master split (and
  every root), the bags that the tasks it gave out were handed, taken
  together, against the leftover: the same number of nodes, and the same
  sum of each digest word taken xor its node's depth (two launches a
  bag).  A part lost, doubled or changed, a digest moved to another
  depth, or a task never run, shows there;
* the reduce: every fold adds its task's count to the state the last fold
  of its tree left, once for each answer, and a finished tree's result is
  the sum of the counts folded into it.
"""
from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..harness import SEED, Check
from ..reference import sha1_uts as ref

M64 = (1 << 64) - 1


def _mix(seed: int, ordinal: int) -> int:
    """splitmix64 of (seed, ordinal): which tasks the check samples."""
    z = (seed * 0x9E3779B97F4A7C15 + ordinal + 1) & M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return z ^ (z >> 31)


def _fingerprint(digests: torch.Tensor, depths: torch.Tensor
                 ) -> torch.Tensor:
    """[5] int64 on the bag's device: each digest word (its int32 bits)
    xor its node's depth, summed over the bag."""
    return torch.sum(digests ^ depths, dim=1, dtype=torch.int64)


def _signed(words: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64, as the int32 bits the program keeps."""
    return torch.where(words >= 2**31, words - 2**32, words)


class _Sample:
    """A sampled task: copies of its input and of its answer."""

    def __init__(self, rec, bag, count: int, left) -> None:
        self.rec, self.count = rec, count
        self.digests, self.depths = bag
        self.left_d, self.left_p = left.digests.clone(), left.depths.clone()


class Driver:
    kernels = ("uts_hash", "uts_expand")

    def __init__(self, cell, seed: int, device, traffic, overrides) -> None:
        self.cfg = {**cell.config, **overrides.get("config", {})}
        self.sample = {**cell.spec["sample"], **overrides.get("sample", {})}
        self.limits = cell.spec["checks"]
        self.warm_depth = overrides.get("warm_depth", cell.spec["warm_depth"])
        self.seed, self.device = seed, device
        self.task_shape = traffic["task_shape"]
        self._reset()

    def _reset(self) -> None:
        self.roots: Dict[int, int] = {}          # job -> root seed
        self.seeds: Dict[int, List[Any]] = {}    # job -> its seed items
        self.outputs: Dict[int, int] = {}        # finished job -> result
        #: task tag -> (nodes, fingerprint) of its input and its leftover
        self.bag_in: Dict[int, Tuple[int, torch.Tensor]] = {}
        self.bag_out: Dict[int, Tuple[int, torch.Tensor]] = {}
        self.samples: List[_Sample] = []
        self.folds = self.fold_bad = 0
        self.last_state: Dict[int, int] = {}
        self.fold_sum: Dict[int, int] = {}

    def root_seed(self, k: int) -> int:
        return (self.cfg["root_seed"] + 65536 * self.seed + k) % 2**32

    def _spec(self, root_seed: int, max_depth: int):
        return self._uts_spec(self._params(
            seed=root_seed, b0=float(self.cfg["b0"]), max_depth=max_depth,
            chunk=int(self.cfg["chunk"])), device=self.device)

    def prepare(self) -> None:
        from repro_torch.algorithms import UTSParams, uts_spec
        from repro_torch.core import TaskShape
        self._params, self._uts_spec = UTSParams, uts_spec
        self.shape = TaskShape(int(self.task_shape["split_factor"]),
                               int(self.task_shape["iters"]))

    def warm(self, run_job) -> None:
        run_job(self._spec(self.root_seed(0) ^ 0x5A5A5A5A, self.warm_depth),
                shape=self.shape)
        self._reset()

    def job(self, k: int):
        self.roots[k] = self.root_seed(k)
        return (self._spec(self.roots[k], int(self.cfg["max_depth"])),
                {"shape": self.shape})

    def job_done(self, k: int, output) -> None:
        self.outputs[k] = int(output)

    def seeded(self, job: int, items) -> None:
        self.seeds[job] = list(items)

    def before(self, job: int, tag: Optional[int], bag):
        copy = None
        if tag is not None and (
                _mix(self.seed, tag) % int(self.sample["period"]) == 0):
            copy = (bag.digests.clone(), bag.depths.clone())
        return _fingerprint(bag.digests, bag.depths), copy

    def after(self, rec, token, bag, result) -> None:
        fp_in, copy = token
        count, left = result
        rec.work = int(count)
        rec.info.update(bag_in=bag.size, leftover=left.size)
        fp_out = _fingerprint(left.digests, left.depths)
        # one dict item set or list append each: atomic under the GIL, so
        # the worker threads take no lock of the benchmark's
        if rec.tag is not None:
            self.bag_in[rec.tag] = (bag.size, fp_in)
            self.bag_out[rec.tag] = (left.size, fp_out)
        if copy is not None:
            self.samples.append(_Sample(rec, copy, int(count), left))

    def folded(self, job: int, tag: Optional[int], state, result,
               new_state) -> None:
        """On the master, after each fold: the reduce's arithmetic, and
        that each fold starts from the state the tree's last one left."""
        count = int(result[0])
        self.folds += 1
        start = self.last_state.get(job, int(state))
        self.fold_bad += (tag is None or int(state) != start
                          or int(new_state) != int(state) + count)
        self.last_state[job] = int(new_state)
        self.fold_sum[job] = self.fold_sum.get(job, 0) + count

    def _split_mismatches(self, lineage) -> Tuple[int, int]:
        """(splits and seeds whose tasks' inputs do not add up to what was
        split, splits checked)."""
        dev = self.device
        tags = sorted(self.bag_in)
        row = {t: i for i, t in enumerate(tags)}
        fps = (torch.stack([self.bag_in[t][1] for t in tags]
                           + [self.bag_out[t][1] for t in tags]).cpu()
               if tags else torch.zeros((0, 5), dtype=torch.int64))
        n_in = [self.bag_in[t][0] for t in tags]
        n_out = [self.bag_out[t][0] for t in tags]
        roots: Dict[int, Tuple[int, torch.Tensor]] = {}
        bad = checked = 0
        for job, parent, kids in lineage.gives:
            if parent == SEED:
                if job not in roots:
                    words = _signed(ref.root_digest(self.roots[job], dev))
                    roots[job] = (1, _fingerprint(
                        words, torch.zeros(1, dtype=torch.int64,
                                           device=dev)).cpu())
                want = roots[job]
            elif parent in row:
                checked += 1
                want = (n_out[row[parent]], fps[len(tags) + row[parent]])
            else:
                bad += 1
                continue
            if any(k not in row for k in kids):
                bad += 1
                continue
            got_fp = (fps[[row[k] for k in kids]].sum(0) if kids
                      else torch.zeros(5, dtype=torch.int64))
            got_n = sum(n_in[row[k]] for k in kids)
            bad += not (got_n == want[0] and torch.equal(got_fp, want[1]))
        return bad + lineage.stray + lineage.split_unmatched, checked

    def check(self, ctx) -> List[Check]:
        dev = self.device
        lim = self.limits
        roots = 0
        for job, root_seed in self.roots.items():
            items = self.seeds.get(job, [])
            want = ref.root_digest(root_seed, dev)
            got_d = (torch.cat([b.digests for b in items], 1) if items
                     else torch.zeros((5, 0), dtype=torch.int32, device=dev))
            got_p = (torch.cat([b.depths for b in items]) if items
                     else torch.zeros(0, dtype=torch.int32, device=dev))
            roots += not (got_d.shape == want.shape and torch.equal(
                got_d.to(torch.int64) & ref.M32, want)
                and not bool(got_p.any()))
        split_bad, splits = self._split_mismatches(ctx.lineage)
        reduce_bad = (self.fold_bad + ctx.lineage.fold_unmatched
                      + ctx.lineage.half_done
                      + sum(out != self.fold_sum.get(job, 0)
                            for job, out in self.outputs.items()))
        cands = [s for s in self.samples if ctx.t0 <= s.rec.end <= ctx.t1]
        chosen = random.Random(self.seed).sample(
            cands, min(int(self.sample["compare"]), len(cands)))
        answers = ref.traverse_many(
            [(s.digests, s.depths) for s in chosen], self.shape.iters,
            b0=float(self.cfg["b0"]), max_depth=int(self.cfg["max_depth"]),
            chunk=int(self.cfg["chunk"]),
            max_children=int(self.cfg["max_children"]))
        tasks_bad = 0
        for s, (count, left_d, left_p) in zip(chosen, answers):
            same = (count == s.count and left_d.shape == s.left_d.shape
                    and torch.equal(s.left_d.to(torch.int64) & ref.M32,
                                    left_d)
                    and torch.equal(s.left_p.to(torch.int64), left_p))
            tasks_bad += not same
        return [
            Check("uts.root_mismatch", roots, lim["uts.root_mismatch"]),
            Check("uts.split_mismatch", split_bad,
                  lim["uts.split_mismatch"]),
            Check("uts.splits_checked", splits,
                  int(self.sample["min_splits"]), ">="),
            Check("uts.reduce_mismatch", reduce_bad,
                  lim["uts.reduce_mismatch"]),
            Check("uts.folds_checked", self.folds,
                  int(self.sample["min_folds"]), ">="),
            Check("uts.task_mismatch", tasks_bad, lim["uts.task_mismatch"]),
            Check("uts.tasks_compared", len(chosen),
                  int(self.sample["min_compare"]), ">="),
        ]

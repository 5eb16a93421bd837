"""Deterministic synthetic data pipeline (sharded, prefetching).

Copy of ``repro.data.pipeline`` (pure numpy, the same Philox streams, so
batch ``i`` is bit for bit the reference's): the port keeps its own copy
rather than importing the reference package.  The batches are numpy
arrays; the training driver turns them into tensors on its device at the
step (``repro_torch.launch.steps.batch_to``), never in the prefetch thread.

Generates reproducible LM batches from a counter-based hash so every
host materializes exactly its shard without coordination: batch ``i`` is
a pure function of (seed, step, global position).  This is the pattern a
real pipeline (SSTable/ArrayRecord shards + per-host sampling) plugs
into: the loader interface is ``__iter__ -> {"tokens": [B_local, S], ...}``.

A background prefetch thread keeps ``prefetch`` batches ready — the data
path must never stall the step loop (compute/IO overlap).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "Prefetcher"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    #: host shard: this loader yields rows [host_ix::n_hosts]
    n_hosts: int = 1
    host_ix: int = 0
    #: frontend stub: if d_model is set, yield embeddings not tokens
    embed_dim: Optional[int] = None


class SyntheticLM:
    """Counter-based deterministic token stream."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        # independent stream per (seed, step, host)
        ss = np.random.SeedSequence(
            [cfg.seed, step, cfg.host_ix, 0xE1A57])
        rng = np.random.Generator(np.random.Philox(ss))
        if cfg.embed_dim is not None:
            embeds = rng.standard_normal(
                (self.local_batch, cfg.seq_len, cfg.embed_dim),
                dtype=np.float32)
            labels = rng.integers(
                0, cfg.vocab_size,
                (self.local_batch, cfg.seq_len)).astype(np.int32)
            return {"embeds": embeds, "labels": labels}
        # markov-ish stream so loss is learnable (not pure noise):
        # token_{t+1} = (a * token_t + noise) mod V
        noise = rng.integers(0, 17, (self.local_batch, cfg.seq_len))
        t0 = rng.integers(0, cfg.vocab_size, (self.local_batch, 1))
        toks = np.zeros((self.local_batch, cfg.seq_len), np.int64)
        toks[:, 0] = t0[:, 0]
        for t in range(1, cfg.seq_len):
            toks[:, t] = (toks[:, t - 1] * 31 + 7 + noise[:, t]) \
                % cfg.vocab_size
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = toks[:, 0]
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of an iterator (depth ``prefetch``)."""

    def __init__(self, it: Iterator, prefetch: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item

"""Plain PyTorch versions of the betweenness-centrality level steps.

The plain versions of the two kernels of ``csrc/bc_level.cu``: the CPU
path of the port, and what the kernels are held against on the card, bit
for bit.  The state of a sweep over N vertices and S sources (the
reference keeps ``[S, N]`` arrays) is vertex-major and updated in place.

Which pairs (v, s) are on which BFS level is kept as bit-packed masks,
int32 words of 32 sources each, bit b of word j standing for source
``32 j + b`` (:func:`pack_bits`):

* ``on[L]``   ``[N, W]``, the pairs on level L;
* ``visited`` ``[N, W]``, the pairs reached so far;
* ``live``    ``[W]``, the sources whose frontier at the current level is
  not empty (a pair of it joined at the level before; every real source
  at level 0).  A source whose frontier is empty reaches no one, so its
  pairs sit out the forward level.

The per-pair values are float32 ``[N, S]`` rows in *level order*
(:func:`put_level`, :func:`level_values`): each row is cut into parts of
:data:`PART` sources, and a part holds its pairs' values level by level,
each level's in source order, from column ``base[L][v, p]`` of the part,
``base[L]`` int32 ``[N, P]`` being the number of the part's pairs on the
levels before L.  So a level's values of a vertex lie together, and a
level writes whole runs, never a column here and there:

* ``sigma``, the number of shortest paths from s to v;
* ``coeff``, ``(1 + delta) / sigma``, written by the backward level that
  finalises the pair's ``delta``;

and ``delta`` ``[N, S]``, the dependency of s on v, in source order,
written once, by the backward level above the pair's (0 before).
:func:`sweep_state` makes a sweep's state at level 0.

A CSR graph is ``(indptr [N + 1], indices [E])``, int32, each row's
neighbours ascending.  Every sum over a row runs sequentially in that
order, starting from +0.0 (:func:`csr_pull`), which is what the kernels
do: so the two agree bit for bit, not merely within a tolerance.  A
neighbour that is not on the level adds +0.0 here and is skipped by the
kernel; both leave a sum of non-negative terms unchanged.  The plain
versions compute on dense ``[N, S]`` arrays and pack their results; the
coefficients they add come from the formula, not from ``coeff``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["PART", "csr_pull", "pack_bits", "unpack_bits", "wrap_int32",
           "level_values", "put_level", "sweep_state",
           "bc_forward_level_ref", "bc_backward_level_ref",
           "sum_over_sources"]

#: sources of a part of a row of values (the part one warp of the
#: kernels takes); a row of fewer sources is one part
PART = 512


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """``[..., S]`` bool -> ``[..., ceil(S / 32)]`` int32: bit b of word j
    is ``mask[..., 32 j + b]``.  Packed in int64 and wrapped to int32, so
    bit 31 is the sign bit."""
    s = mask.shape[-1]
    words = -(-s // 32)
    if words * 32 != s:
        mask = torch.cat([mask, mask.new_zeros(
            (*mask.shape[:-1], words * 32 - s))], dim=-1)
    m = mask.reshape(*mask.shape[:-1], words, 32)
    out = torch.zeros(m.shape[:-1], dtype=torch.int64, device=mask.device)
    for b in range(32):
        out |= m[..., b].long() << b
    return wrap_int32(out)


def wrap_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words of 32 bits, 0 .. 2**32 - 1 -> int32 of the same bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits(words: torch.Tensor, s: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: ``[..., W]`` int32 -> ``[..., s]``
    bool.  An arithmetic right shift keeps bit b at the bottom for every
    b, the sign bit included."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :s].bool()


def _parts(t: torch.Tensor) -> torch.Tensor:
    """``[N, S]`` -> ``[N, P, S / P]``, a view: parts of :data:`PART`
    sources, or the whole row if it is shorter."""
    s = t.shape[-1]
    width = min(s, PART)
    if s % width:
        raise ValueError(f"{s} sources do not cut into parts of {PART}")
    return t.reshape(*t.shape[:-1], s // width, width)


def _part_counts(mask: torch.Tensor) -> torch.Tensor:
    """``[N, S]`` bool -> ``[N, P]`` int32: the pairs set in each part."""
    return _parts(mask).sum(-1, dtype=torch.int32)


def _columns(mask: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Each set pair's column within its part in level order: ``base``
    plus the set pairs before it in the part (``[N, P, S / P]``)."""
    m = _parts(mask)
    return base.unsqueeze(-1) + m.to(torch.int32).cumsum(
        -1, dtype=torch.int32) - 1


def level_values(packed: torch.Tensor, mask: torch.Tensor,
                 base: torch.Tensor) -> torch.Tensor:
    """The values of the pairs in ``mask`` (one level's) back at their
    source columns, zeros elsewhere: ``[N, S]``, from level-ordered
    ``packed`` rows whose level starts at ``base`` ``[N, P]``."""
    m = _parts(mask)
    at = _columns(mask, base).clamp(0, m.shape[-1] - 1).long()
    got = torch.gather(_parts(packed), -1, at)
    return torch.where(m, got, torch.zeros((), dtype=packed.dtype,
                                           device=packed.device)
                       ).reshape(packed.shape)


def put_level(packed: torch.Tensor, mask: torch.Tensor, values: torch.Tensor,
              base: torch.Tensor) -> None:
    """Writes ``values`` (``[N, S]``, source order) of the pairs in
    ``mask`` into the level-ordered ``packed`` rows, in place, the level
    starting at ``base`` ``[N, P]``."""
    m = _parts(mask)
    _parts(packed)[m.nonzero(as_tuple=True)[:-1] +
                   (_columns(mask, base)[m].long(),)] = _parts(values)[m]


def sweep_state(n: int, sources: torch.Tensor, s_pad: int) -> dict:
    """A sweep's state at level 0 for ``sources`` (S of them, on their
    device) over ``s_pad`` >= S columns: ``sigma`` (1 for each source
    pair, its level-0 value, in level order) and ``coeff`` (zeros)
    ``[N, s_pad]``, ``visited`` and ``on`` (level 0) ``[N, s_pad / 32]``,
    level 0's ``base`` (zeros) and the ``live`` words ``[s_pad / 32]``.
    A padded column is no source: its bits are clear, and it never
    joins."""
    dev = sources.device
    cols = torch.arange(sources.shape[0], device=dev)
    # each source's bit in its vertex's word: distinct bits, so their sum
    # is their OR
    bits = torch.zeros((n, s_pad // 32), dtype=torch.int64, device=dev)
    bits.index_put_((sources, cols // 32),
                    torch.ones_like(cols) << (cols % 32), accumulate=True)
    on = wrap_int32(bits)
    rows, row_of = torch.unique(sources, return_inverse=True)
    mask = torch.zeros((rows.shape[0], s_pad), dtype=torch.bool, device=dev)
    mask[row_of, cols] = True
    base = torch.zeros((n, max(1, s_pad // PART)), dtype=torch.int32,
                       device=dev)
    sigma = torch.zeros((n, s_pad), dtype=torch.float32, device=dev)
    level0 = torch.zeros((rows.shape[0], s_pad), dtype=torch.float32,
                         device=dev)
    put_level(level0, mask, torch.ones_like(level0), base[rows])
    sigma[rows] = level0
    live = pack_bits(torch.arange(s_pad, device=dev) < sources.shape[0])
    return {"sigma": sigma, "coeff": torch.zeros_like(sigma),
            "visited": on.clone(), "on": on, "base": base, "live": live}


def csr_pull(indptr: torch.Tensor, indices: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum(val[indices[j]] for j in row r)``, each row summed
    left to right in CSR order from +0.0; ``val`` is ``[N, S]``.

    Rows are visited in order of falling degree, so that step k adds the
    k-th neighbour of a prefix of them: one gather and one add per
    position, max degree steps in all.
    """
    n = indptr.shape[0] - 1
    deg = indptr[1:] - indptr[:-1]
    order = torch.argsort(deg, descending=True, stable=True)
    start = indptr[:-1][order].long()
    deg_np = deg.cpu().numpy()
    # rows of degree > k, for every k < max degree
    rows = n - np.cumsum(np.bincount(deg_np, minlength=1))
    acc = torch.zeros((n, val.shape[1]), dtype=val.dtype, device=val.device)
    idx = indices.long()
    for k in range(int(deg_np.max(initial=0))):
        r = int(rows[k])
        acc[:r] += val[idx[start[:r] + k]]
    out = torch.empty_like(acc)
    out[order] = acc
    return out


def _coeff(delta: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """``(1 + delta) / safe_sigma``, the reference's coefficient
    (``betweenness.py:122``), tensor by tensor: the kernels' expression,
    bit for bit."""
    return (1.0 + delta) / torch.where(sigma > 0, sigma, 1.0)


def bc_forward_level_ref(in_indptr: torch.Tensor, in_indices: torch.Tensor,
                         sigma: torch.Tensor, visited: torch.Tensor,
                         on: torch.Tensor, base: torch.Tensor,
                         live: torch.Tensor, *, level: int) -> tuple:
    """One forward BFS level, in place: every pair (v, s) not visited of a
    live source with ``reach = sum(sigma[u, s] for u in in(v) if (u, s)
    on the level) > 0`` joins the next level with ``sigma = reach``,
    written in level order after the part's pairs visited before, and is
    set in ``visited``.  ``level`` names the level
    of ``on`` (for the steps hooks; the masks carry it).  Returns the next
    level's ``(on, base, live)``: the packing of the pairs that joined,
    where their values start, and the packing of the sources of which a
    pair joined."""
    s = sigma.shape[1]
    reach = csr_pull(in_indptr, in_indices,
                     level_values(sigma, unpack_bits(on, s), base))
    seen = unpack_bits(visited, s)
    joined = ~seen & unpack_bits(live, s) & (reach > 0)
    base_next = _part_counts(seen)
    put_level(sigma, joined, reach, base_next)
    visited.copy_(pack_bits(seen | joined))
    return pack_bits(joined), base_next, pack_bits(joined.any(dim=0))


def bc_backward_level_ref(out_indptr: torch.Tensor, out_indices: torch.Tensor,
                          sigma: torch.Tensor, delta: torch.Tensor,
                          coeff: torch.Tensor, on: torch.Tensor,
                          on_below: torch.Tensor, base: torch.Tensor,
                          base_below: torch.Tensor, *,
                          level: int) -> torch.Tensor:
    """One backward level, in place: with ``c[w] = (1 + delta[w]) /
    safe_sigma[w]`` for the pairs on ``level`` (``on``, their values from
    ``base``), else 0, every pair (u, s) on ``level - 1`` (``on_below``,
    ``base_below``) gets ``delta[u] = sigma[u] * back[u]``, ``back[u] =
    sum(c[w] for w in out(u))``, and then its ``coeff``.  The reference
    adds to ``delta``, which is 0 there: a pair is on one level, and this
    is the one launch that writes its ``delta``; the product is +0.0 or
    positive, so the two have the same bits.  The reference multiplies by
    a 0/1 mask instead of selecting; the two agree wherever ``1 + delta``
    is finite.  Returns ``delta``."""
    if level < 1:
        raise ValueError(f"bc_backward_level: level {level} < 1")
    s = sigma.shape[1]
    here, below = unpack_bits(on, s), unpack_bits(on_below, s)
    zero = torch.zeros((), dtype=delta.dtype, device=delta.device)
    c = torch.where(here, _coeff(delta, level_values(sigma, here, base)),
                    zero)
    back = csr_pull(out_indptr, out_indices, c)
    sig = level_values(sigma, below, base_below)
    delta.copy_(torch.where(below, sig * back, delta))
    put_level(coeff, below, _coeff(delta, sig), base_below)
    return delta


def sum_over_sources(delta: torch.Tensor) -> torch.Tensor:
    """``[N, S]`` -> ``[N]``: pairwise halving over S, a power of two, so
    the sum has one fixed order on every device."""
    s = delta.shape[1]
    if s & (s - 1):
        raise ValueError(f"source axis {s} is not a power of two")
    while delta.shape[1] > 1:
        h = delta.shape[1] // 2
        delta = delta[:, :h] + delta[:, h:]
    return delta[:, 0]

"""Plain PyTorch SHA-1 child digests, UTS traversal and tree-shape helpers.

The plain versions of the ``uts_hash`` and ``uts_expand`` kernels
(``csrc/uts_hash.cu``): the CPU path of the port, and what the kernels
are held against on the card.

Digests are carried as **int32** tensors holding the uint32 bit pattern:
PyTorch has no shift, add or not for ``torch.uint32`` on the CPU.  int32
addition wraps the same way uint32 addition does, and ``_rotl`` masks
its arithmetic right shift down to a logical one.  Convert to and from
numpy uint32 with ``.view``, never with a value cast.

Child counts come from an integer threshold table instead of a float
``log``: PyTorch's float32 ``log`` rounds differently from numpy's on a
few u31 values, and over a large tree one differing count changes the
node count.  :func:`child_count_thresholds` finds, by binary search over
a private copy of the reference package's numpy map, the u31 values
where the count steps down; on the device a count is then one
``searchsorted``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["sha1_words", "uts_child_digests_ref", "root_digest",
           "random_u31", "geometric_children", "child_count_thresholds",
           "expand_generation", "uts_expand_ref"]

_H0 = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)
_K = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)


def _s32(v: int) -> int:
    """uint32 value -> the int32 with the same bits."""
    return v - (1 << 32) if v >= (1 << 31) else v


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    n = n % 32
    return (x << n) | ((x >> (32 - n)) & ((1 << n) - 1))


def sha1_words(words16: list) -> list:
    """One SHA-1 compression over a 16-word block.

    ``words16``: 16 int32 tensors of one shape (uint32 bits), big-endian
    word order.  Returns the 5 digest words, int32.
    """
    w = list(words16)
    for i in range(16, 80):
        w.append(_rotl(w[i - 3] ^ w[i - 8] ^ w[i - 14] ^ w[i - 16], 1))
    ref = w[0]
    a, b, c, d, e = (torch.full_like(ref, _s32(h)) for h in _H0)
    for i in range(80):
        if i < 20:
            f = (b & c) | (torch.bitwise_not(b) & d)
            k = _K[0]
        elif i < 40:
            f = b ^ c ^ d
            k = _K[1]
        elif i < 60:
            f = (b & c) | (b & d) | (c & d)
            k = _K[2]
        else:
            f = b ^ c ^ d
            k = _K[3]
        tmp = _rotl(a, 5) + f + e + _s32(k) + w[i]
        e, d, c, b, a = d, c, _rotl(b, 30), a, tmp
    return [a + _s32(_H0[0]), b + _s32(_H0[1]), c + _s32(_H0[2]),
            d + _s32(_H0[3]), e + _s32(_H0[4])]


def uts_child_digests_ref(parent: torch.Tensor,
                          child_ix: torch.Tensor) -> torch.Tensor:
    """SHA1(parent_digest || be32(child_ix)) for a batch of nodes.

    parent:   [5, N] int32 (uint32 bits), word-major
    child_ix: [N]    int32 (uint32 bits)
    returns   [5, N] int32 child digests
    """
    parent = parent.to(torch.int32)
    n = parent.shape[1]
    zero = torch.zeros(n, dtype=torch.int32, device=parent.device)
    # 24-byte message -> one padded block:
    #   w0..w4 = parent words, w5 = child index, w6 = 0x80000000 (pad bit),
    #   w7..w14 = 0, w15 = 192 (bit length of the message).
    words = [parent[i] for i in range(5)]
    words.append(child_ix.to(torch.int32))
    words.append(torch.full_like(zero, _s32(0x80000000)))
    words.extend([zero] * 8)
    words.append(torch.full_like(zero, 24 * 8))
    return torch.stack(sha1_words(words))


def root_digest(seed: int, device: torch.device) -> torch.Tensor:
    """Root node state: SHA1(zero_digest || be32(seed)), [5, 1] int32."""
    zero = torch.zeros((5, 1), dtype=torch.int32, device=device)
    ix = torch.from_numpy(np.array([seed], np.uint32).view(np.int32))
    return uts_child_digests_ref(zero, ix.to(device))


def random_u31(digest: torch.Tensor) -> torch.Tensor:
    """31-bit uniform integer from a [5, N] digest batch -> [N] int32."""
    return (digest[0] >> 1) & 0x7FFFFFFF


def _geometric_children_np(u31: np.ndarray, b0: float,
                           max_children: int) -> np.ndarray:
    """Private copy of the reference package's ``geometric_children_np``
    (``repro/kernels/uts_hash/numpy_impl.py``), on u31 values and
    without the depth cutoff: the float32 map u31 -> Geometric(b0)."""
    u31 = u31.astype(np.int64).astype(np.float32)
    u = (u31 + 1.0) / (2147483648.0 + 1.0)
    p = 1.0 / (1.0 + b0)
    m = np.floor(np.log(u) / math.log(1.0 - p)).astype(np.int32)
    return np.clip(m, 0, max_children)


@functools.lru_cache(maxsize=16)
def child_count_thresholds(b0: float, max_children: int) -> np.ndarray:
    """Ascending int32 table T with count(u31) = #{t in T : u31 < t}.

    The numpy map is non-increasing in u31, so for k = 1..max_children
    the u31 values with count >= k are exactly [0, T_k), T_k being the
    least u31 whose count is below k.  All T_k are found together by
    binary search (31 vectorized steps); 2**31 stands for "never"."""
    k = np.arange(1, max_children + 1, dtype=np.int64)
    lo = np.zeros_like(k)
    hi = np.full_like(k, 1 << 31)
    while np.any(lo < hi):
        mid = (lo + hi) // 2
        below = _geometric_children_np(np.minimum(mid, (1 << 31) - 1), b0,
                                       max_children) < k
        hi = np.where((lo < hi) & below, mid, hi)
        lo = np.where((lo < hi) & ~below, mid + 1, lo)
    if np.any(hi >= 1 << 31):
        raise ValueError(
            f"b0={b0}: some count is never reached below 2**31")
    return np.sort(hi).astype(np.int32)


@functools.lru_cache(maxsize=16)
def _thresholds_on(b0: float, max_children: int,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(child_count_thresholds(b0, max_children)).to(device)


def geometric_children(digest: torch.Tensor, depth: torch.Tensor, *,
                       b0: float = 4.0, max_depth: int = 18,
                       max_children: int = 64) -> torch.Tensor:
    """Number of children per node, Geometric(mean=b0), 0 past cutoff.

    Bit-equal to the reference package's ``geometric_children_np`` (the
    float32 ``floor(log(u) / log(1 - p))`` map, clipped to
    ``max_children``) on every device, through the threshold table.
    """
    u31 = random_u31(digest).contiguous()
    thr = _thresholds_on(float(b0), int(max_children), u31.device)
    m = max_children - torch.searchsorted(thr, u31, right=True)
    return torch.where(depth >= max_depth, 0, m).to(torch.int32)


def expand_generation(digests: torch.Tensor, depths: torch.Tensor,
                      counts: torch.Tensor,
                      total: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The children of a generation of nodes: parent-major, child index
    minor.  ``counts`` [n] int64 children per node, ``total`` their sum.
    Returns (child digests [5, total], child depths [total])."""
    dev = depths.device
    if total == 0:
        return (torch.zeros((5, 0), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev))
    parent_ix = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), counts, output_size=total)
    # child index within each parent: 0..m_i-1
    offsets = torch.cumsum(counts, 0) - counts
    child_ix = (torch.arange(total, device=dev)
                - offsets[parent_ix]).to(torch.int32)
    children = uts_child_digests_ref(digests[:, parent_ix], child_ix)
    return children, depths[parent_ix] + 1


def uts_expand_ref(digests: torch.Tensor, depths: torch.Tensor, iters: int,
                   *, b0: float, max_depth: int, chunk: int,
                   max_children: int = 64, capacity: Optional[int] = None
                   ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Traverse up to ``iters`` nodes of the bag (digests [5, S] int32,
    depths [S] int32); return (count, leftover digests, leftover depths).

    LIFO by generations: each takes the top ``min(S, iters - count,
    chunk)`` nodes and pushes their children in their place.  With a
    ``capacity``, stops before the first generation whose stack would
    exceed it, with that generation undone, as the kernel does when its
    work buffer is full.
    """
    count = 0
    while count < iters and depths.shape[0]:
        size = depths.shape[0]
        take = min(size, iters - count, chunk)
        cut = size - take
        head_d, head_p = digests[:, cut:], depths[cut:]
        counts = geometric_children(head_d, head_p, b0=b0,
                                    max_depth=max_depth,
                                    max_children=max_children
                                    ).to(torch.int64)
        total = int(counts.sum())
        if capacity is not None and cut + total > capacity:
            break
        children, child_depths = expand_generation(head_d, head_p, counts,
                                                   total)
        digests = torch.cat([digests[:, :cut], children], dim=1)
        depths = torch.cat([depths[:cut], child_depths])
        count += take
    return count, digests, depths

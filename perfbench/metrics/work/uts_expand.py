"""Least time of one UTS task's traversal (``uts_expand``).

A task that pops ``count`` nodes from a bag of ``bag_in`` and leaves
``leftover`` has hashed ``leftover - bag_in + count`` children (every
node pushed is a child hashed).  Each child costs one SHA-1 compression of
901 32-bit operations: 64 schedule words (3 xor and a rotate), 80 rounds
(2 rotates, 4 adds, a 2-operation boolean function on average), 5 final
adds.  The bag is read once and the leftover written once, 24 bytes a node
(a 20-byte digest and a 4-byte depth).  The least time is the larger of
the operations at ``PEAK_OPS_S`` and the bytes at ``HBM_BW``.
"""
from .peaks import HBM_BW, PEAK_OPS_S

OPS_PER_CHILD = 64 * 4 + 80 * 8 + 5
BYTES_PER_NODE = 24


def children(bag_in: int, count: int, leftover: int) -> int:
    return leftover - bag_in + count


def least_s(bag_in: int, count: int, leftover: int) -> float:
    ops = children(bag_in, count, leftover) * OPS_PER_CHILD
    n_bytes = (bag_in + leftover) * BYTES_PER_NODE
    return max(ops / PEAK_OPS_S, n_bytes / HBM_BW)

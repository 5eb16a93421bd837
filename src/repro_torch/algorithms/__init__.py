"""The paper's irregular algorithms as ``WorkSpec`` definitions (port).

Each module exports a ``*_spec`` factory consumed by
``repro_torch.core.run_irregular`` over a ``make_pool`` backend: UTS,
Mariani-Silver and betweenness centrality.
"""
from .uts import (
    Bag,
    UTSParams,
    expand_bag,
    expected_tree_size,
    uts_sequential,
    uts_spec,
)
from .mariani_silver import (
    Action,
    MSParams,
    Rect,
    evaluate_rect,
    evaluate_rects,
    ms_spec,
    naive_render,
)
from .betweenness import (
    BCResult,
    CSRGraph,
    RMATParams,
    bc_batch,
    bc_single_node,
    bc_spec,
    rmat_graph,
)

__all__ = [
    "Bag", "UTSParams", "expand_bag", "expected_tree_size",
    "uts_sequential", "uts_spec",
    "Action", "MSParams", "Rect", "evaluate_rect", "evaluate_rects",
    "ms_spec", "naive_render",
    "BCResult", "CSRGraph", "RMATParams", "bc_batch", "bc_single_node",
    "bc_spec", "rmat_graph",
]

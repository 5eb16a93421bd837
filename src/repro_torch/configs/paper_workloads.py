"""The paper's own workload configurations (Table 2 / §4.4).

Copy of ``repro.configs.paper_workloads`` over the port's parameter
classes:

  UTS              seed=19, b0=4, d=18 (Table 1 sweeps d=14..18)
  Mariani-Silver   4096x4096, max dwell 5M, sd in {64, 256}, depth {5, 4}
  BC               SSCA2 kernel 4, R-MAT (0.55,0.1,0.1,0.25), seed=2,
                   T=128 tasks, scale N=17

``*_SCALED`` variants are the reference package's small versions (same
structure, smaller exponents).
"""
from ..algorithms.betweenness import RMATParams
from ..algorithms.mariani_silver import MSParams
from ..algorithms.uts import UTSParams

__all__ = ["UTS_PAPER", "UTS_TABLE1_DEPTHS", "MS_PAPER_SD64",
           "MS_PAPER_SD256", "BC_PAPER", "BC_PAPER_TASKS", "UTS_SCALED",
           "MS_SCALED", "BC_SCALED", "BC_SCALED_TASKS"]

# -- paper-exact --------------------------------------------------------------
UTS_PAPER = UTSParams(seed=19, b0=4.0, max_depth=18)
UTS_TABLE1_DEPTHS = (14, 15, 16, 17, 18)

MS_PAPER_SD64 = MSParams(width=4096, height=4096, max_dwell=5_000_000,
                         initial_subdivision=64, max_depth=5, split=2)
MS_PAPER_SD256 = MSParams(width=4096, height=4096, max_dwell=5_000_000,
                          initial_subdivision=256, max_depth=4, split=2)

BC_PAPER = RMATParams(scale=17, edge_factor=8, seed=2,
                      a=0.55, b=0.10, c=0.10, d=0.25)
BC_PAPER_TASKS = 128

# -- scaled -------------------------------------------------------------------
UTS_SCALED = UTSParams(seed=19, b0=4.0, max_depth=10, chunk=4096)
MS_SCALED = MSParams(width=384, height=384, max_dwell=2048,
                     initial_subdivision=2, max_depth=5, split=2)
BC_SCALED = RMATParams(scale=8, edge_factor=8, seed=2)
BC_SCALED_TASKS = 32

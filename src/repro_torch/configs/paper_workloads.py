"""The paper's own UTS and Mariani-Silver configurations (Table 2 / §4.4).

Copy of the UTS and Mariani-Silver rows of
``repro.configs.paper_workloads`` over the port's parameter classes:

  UTS              seed=19, b0=4, d=18 (Table 1 sweeps d=14..18)
  Mariani-Silver   4096x4096, max dwell 5M, sd in {64, 256}, depth {5, 4}

``*_SCALED`` variants are the reference package's small versions (same
structure, smaller exponents).  BC's rows come with the BC slice.
"""
from ..algorithms.mariani_silver import MSParams
from ..algorithms.uts import UTSParams

__all__ = ["UTS_PAPER", "UTS_TABLE1_DEPTHS", "MS_PAPER_SD64",
           "MS_PAPER_SD256", "UTS_SCALED", "MS_SCALED"]

# -- paper-exact --------------------------------------------------------------
UTS_PAPER = UTSParams(seed=19, b0=4.0, max_depth=18)
UTS_TABLE1_DEPTHS = (14, 15, 16, 17, 18)

MS_PAPER_SD64 = MSParams(width=4096, height=4096, max_dwell=5_000_000,
                         initial_subdivision=64, max_depth=5, split=2)
MS_PAPER_SD256 = MSParams(width=4096, height=4096, max_dwell=5_000_000,
                          initial_subdivision=256, max_depth=4, split=2)

# -- scaled -------------------------------------------------------------------
UTS_SCALED = UTSParams(seed=19, b0=4.0, max_depth=10, chunk=4096)
MS_SCALED = MSParams(width=384, height=384, max_dwell=2048,
                     initial_subdivision=2, max_depth=5, split=2)

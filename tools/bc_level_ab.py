"""Times the betweenness-centrality level kernels of one checkout, to
compare two builds of ``csrc/bc_level.cu`` on one card.

    python tools/bc_level_ab.py CHECKOUT TAG [check]

builds CHECKOUT's ``bc_level`` (into CHECKOUT/build), prints its ``ptxas``
register and spill lines, and for each of ``chip_smoke.BC_FIXED``'s shapes
(the smoke run's graphs and sources) the per-level kernel times, medians
of 10 sweeps between CUDA events (``chip_smoke.bc_sweep_times``).  With
``check`` it first holds every level to the plain version bit for bit and
prints ``torch.sparse.mm``'s time for each level's product
(``chip_smoke.BCTwinLevels``).  Compare two builds by unpacking each into
a directory of its own and running them in turns on the same card, one
after another: A, B, B, A.  Needs a CUDA card and ``nvcc``.
"""
import os
import sys
import time

d = os.path.abspath(sys.argv[1])
tag = sys.argv[2]
check = len(sys.argv) > 3
os.chdir(d)
sys.path[:0] = [d, os.path.join(d, "src")]
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.algorithms import RMATParams, bc_batch, rmat_graph  # noqa
from repro_torch.configs.paper_workloads import BC_PAPER, BC_SCALED  # noqa
from repro_torch.kernels import _build  # noqa: E402

dev = torch.device("cuda", 0)
t = time.monotonic()
_build.build(["bc_level"])
print(f"== {tag}: build {time.monotonic() - t:.1f} s", flush=True)
for line in _build.compiler_report("bc_level").splitlines():
    if "registers" in line or "spill" in line:
        print("   ", line.strip())
for scale, s in cs.BC_FIXED:
    scaled = scale == BC_SCALED.scale
    g = rmat_graph(BC_SCALED if scaled else RMATParams(
        scale=scale, seed=BC_PAPER.seed)).to(dev)
    src = torch.arange(s, device=dev) if s == 1024 or scaled else \
        torch.from_numpy(np.random.default_rng(scale).choice(
            g.n, s, replace=False)).to(dev)
    lib = ""
    if check:
        twin = cs.BCTwinLevels(g)
        bc_batch(g, src, steps=(twin.forward, twin.backward))
        lib = (" lib fwd " + " ".join(f"{r['library_ms']:.4f}"
                                      for r in twin.fwd)
               + " bwd " + " ".join(f"{r['library_ms']:.4f}"
                                    for r in twin.bwd))
    f, b = cs.bc_sweep_times(g, src, "cuda", reps=10)
    print(f"{tag} scale {scale} S {s}: fwd {sum(f):.4f} bwd {sum(b):.4f} "
          f"task {sum(f) + sum(b):.4f}" + (" (bit-equal)" if check else ""))
    print("   fwd " + " ".join(f"{x:.4f}" for x in f))
    print("   bwd " + " ".join(f"{x:.4f}" for x in b))
    if lib:
        print("  " + lib)
    del g
    torch.cuda.empty_cache()

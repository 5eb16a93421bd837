"""One model phase of ``chip_smoke.py`` alone, to iterate on it.

    python tools/model_phase.py {model,families,recurrent,training}

runs the smoke's environment and build phases, then ``phase_model``
(gemma3-1b), ``phase_model_families`` (deepseek-moe-16b, deepseek-v3 and
the dense and frontend configs), ``phase_recurrent_families`` (rwkv6-1.6b
and jamba's period) or ``phase_training`` (the flash backward kernel,
gemma3-1b's gradient and its training killed and resumed, MoE training,
the ``train_lm`` twin, the scans' backward kernels and rwkv6-1.6b's and
jamba's training) on the card, with the smoke's settings, and writes
the phase's record to ``chiprun_out/<phase>.json``.  Needs a CUDA card and
``nvcc``; the recurrent phase takes some 2 minutes with the build.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PHASES = {"model": cs.phase_model, "families": cs.phase_model_families,
          "recurrent": cs.phase_recurrent_families,
          "training": cs.phase_training}
name = sys.argv[1] if len(sys.argv) > 1 else "recurrent"
if name not in PHASES or not torch.cuda.is_available():
    sys.exit(f"usage: python tools/model_phase.py {{{','.join(PHASES)}}} "
             f"(on a CUDA card)")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
cs.phase_environment()
cs.phase_build()
rec = PHASES[name](torch.device("cuda", 0))
cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
(cs.OUT_DIR / f"{name}.json").write_text(json.dumps(rec, indent=1,
                                                   default=str))
print(f"[done] {name}: {cs.OUT_DIR / f'{name}.json'}")

"""How MoE routing amplifies the flash kernel's rounding in a whole model.

    python tools/moe_routing_diag.py [ARCH] [S]

runs ARCH (default deepseek-moe-16b) at full width and depth with random
bf16 weights from seed 0 on the card, and prefills the same S tokens
(default 4096; ``chip_smoke.family_inputs``) at capacity factors 1.25 (the
config's), 4 and 16.  For each it prints, against the plain version's
last-position logits (max |d| over the largest |logit|, and the cosine):
the kernel's with each run routing for itself, with the plain run
replaying the kernel run's routing (``chip_smoke.MoETap``), and a second
kernel and a second plain run (each path's own determinism); the
(layer, token) expert sets that differ between kernel and plain routing
for themselves; the pairs dropped at capacity; and the last token's pairs
dropped in a prefill of S + 1 tokens.  Writes ``moe_routing_diag.json``
beside the smoke run's report (``chip_smoke.OUT_DIR``).  Needs a CUDA
card and ``nvcc``.
"""
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_params, prefill  # noqa: E402

arch = sys.argv[1] if len(sys.argv) > 1 else cs.MOE_ARCH
s = int(sys.argv[2]) if len(sys.argv) > 2 else cs.MODEL_CMP_S
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
cs.phase_environment()
cs.phase_build()
dev = torch.device("cuda", 0)
base = get_config(arch)
out = {"arch": arch, "seq": s}
with torch.inference_mode():
    params = init_params(base, 0, device=dev)
    inputs = cs.family_inputs(base, s + 1, dev, seed=7)
    head = cs.model_batch(base, inputs, 0, s)
    for cf in (base.moe.capacity_factor, 4.0, 16.0):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=cf))
        with cs.MoETap() as kernel:
            lk, _ = prefill(cfg, params, head)
        with cs.MoETap() as plain:
            lr, _ = prefill(cfg, params, head, backend="ref")
        with cs.MoETap(replay=kernel):
            lrep, _ = prefill(cfg, params, head, backend="ref")
        lk2, _ = prefill(cfg, params, head)
        lr2, _ = prefill(cfg, params, head, backend="ref")
        with cs.MoETap() as longer:
            prefill(cfg, params, cs.model_batch(base, inputs, 0, s + 1))
        rec = {"kernel_vs_plain": cs.logits_gap(lk, lr),
               "kernel_vs_plain_routing_replayed": cs.logits_gap(lk, lrep),
               "kernel_vs_kernel": cs.logits_gap(lk2, lk),
               "plain_vs_plain": cs.logits_gap(lr2, lr),
               "flips": kernel.flips(plain),
               "dropped": sum(kernel.dropped()),
               "pairs": s * cfg.moe.top_k * len(kernel.layers),
               "last_token_dropped_in_longer": longer.last_token_dropped()}
        print(f"capacity factor {cf}: {json.dumps(rec)}", flush=True)
        out[str(cf)] = rec
cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
(cs.OUT_DIR / "moe_routing_diag.json").write_text(json.dumps(out, indent=1))

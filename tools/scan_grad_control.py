"""Why the recurrent configs' whole-model gradient gate runs in float32.

    python tools/scan_grad_control.py

On phase 13's operands for rwkv6-1.6b (full width and depth, random
weights from seed 0, batch 1 of 1,024 tokens) it reads the gate's three
numbers (the loss's relative gap, the global gradient norm's relative gap
and the lowest leaf cosine, each against the plain versions,
``chip_smoke.grad_gap``) three times:

* bf16 weights (the config's own), the ``wkv6_bwd`` kernel against the
  plain backward;
* bf16 weights, a control: the plain backward with each of its outputs
  multiplied by (1 + 2**-23 n), n standard normal from a seed (a float32
  rounding's size), against the plain backward;
* float32 weights, the kernel against the plain backward.

With bf16 weights the gradient is chaotic at float32 rounding's scale (a
perturbation flips bf16 roundings, which grow through the 24 layers), so
the control misses the gate as the kernel does; in float32 the kernel
meets it.  It prints each with the leaves of lowest cosine and writes
``chiprun_out/scan_grad_control.json``.  Needs a CUDA card and ``nvcc``;
some 4 minutes (each plain gradient some 85 s).
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
from repro_torch.kernels.dispatch import get_kernel, register_kernel  # noqa
from repro_torch.kernels.wkv6.ops import wkv6_bwd_ref  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("tools/scan_grad_control.py needs a CUDA card")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
card = cs.phase_environment()
dev = torch.device("cuda", 0)
report: dict = {"card": card}


def gate(label: str, got: tuple, plain: tuple) -> None:
    rec = cs.grad_gap(got, plain)
    leaves = []
    for n in got[1]:
        x, y = got[1][n].float().flatten(), plain[1][n].float().flatten()
        nx, ny = float(x.norm()), float(y.norm())
        leaves.append((1.0 if nx == ny == 0 else float(x @ y)
                       / max(nx * ny, 1e-30), n))
    rec["lowest"] = sorted(leaves)[:5]
    rec["passes"] = cs.grad_gate_passes(rec)
    report[label] = rec
    print(f"[control] {label}: loss gap {rec['loss_rel_err']:.3e}, norm gap "
          f"{rec['grad_norm_rel_err']:.3e} (allowed {cs.GRAD_NORM_RTOL}), "
          f"lowest cosine {rec['min_cosine']:.6f} (allowed >= "
          f"{cs.GRAD_MIN_COS}); gate passes {rec['passes']}; lowest "
          + ", ".join(f"{n} {c:.6f}" for c, n in rec["lowest"]), flush=True)


cfg = get_config(cs.RWKV_ARCH)
toks = cs.family_inputs(cfg, cs.GRAD_CHECK_S + 1, dev, seed=4)
batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
params = init_params(cfg, 0, device=dev)
plain = cs.model_grads(cfg, params, batch, "ref")
gate("bf16 kernel", cs.model_grads(cfg, params, batch, None), plain)
op = get_kernel("wkv6_bwd")
gen = torch.Generator(device=dev).manual_seed(0)


def noisy(*args):
    """The plain backward, each output times (1 + 2**-23 n)."""
    return tuple(t * (1 + 2.0**-23 * torch.randn(t.shape, device=t.device,
                                                 generator=gen))
                 for t in wkv6_bwd_ref(*args))


register_kernel(dataclasses.replace(op, reference_body=noisy))
try:
    control = cs.model_grads(cfg, params, batch, "ref")
finally:
    register_kernel(op)
gate("bf16 control (plain backward x (1 + 2^-23 n))", control, plain)
del params, plain, control
torch.cuda.empty_cache()
cfg32 = dataclasses.replace(cfg, dtype="float32")
params = init_params(cfg32, 0, device=dev)
gate("float32 kernel", cs.model_grads(cfg32, params, batch, None),
     cs.model_grads(cfg32, params, batch, "ref"))
cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
(cs.OUT_DIR / "scan_grad_control.json").write_text(json.dumps(report,
                                                              indent=1))
print(f"[done] report in {cs.OUT_DIR / 'scan_grad_control.json'}")

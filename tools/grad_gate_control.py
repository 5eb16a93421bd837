"""The whole-model gradient gate of ``chip_smoke.py`` against a control.

    python tools/grad_gate_control.py

On phase 13's operands (gemma3-1b at full width and depth, random bf16
weights from seed 0, batch 1 of 4,096) it reads the gate's three numbers
(the loss's relative gap, the global gradient norm's relative gap and the
lowest leaf cosine, each against the plain versions) twice: with the
hand-written backward kernel, and with a control backward that rounds p
and dS to bf16 before its three products, as a tensor-core kernel with
bf16 operands would (everything else in float32, the same forward
kernel).  It prints both against the gate's limits and writes
``chiprun_out/grad_gate_control.json``.  Needs a CUDA card and ``nvcc``.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.flash_attention.ops import FlashAttention  # noqa

KERNEL_BACKWARD = FlashAttention.backward


def bf16_ds_backward(ctx, dout):
    """The flash backward in float32 with p and dS rounded to bf16 before
    dV = p^T dO, dQ = dS k and dK = dS^T q; the plain backend's own
    backward where the forward was the plain version."""
    if ctx.opts["backend"] == "ref":
        return KERNEL_BACKWARD(ctx, dout)
    q2, k2, v2, o, lse = ctx.saved_tensors
    causal, window, softcap = (ctx.opts[k] for k in ("causal", "window",
                                                      "softcap"))
    bhg, sq, dk = q2.shape
    bhkv, skv, dv = v2.shape
    g = bhg // bhkv
    q = q2.float().reshape(bhkv, g, sq, dk)
    k, v = k2.float()[:, None], v2.float()[:, None]
    do = dout.float().reshape(bhkv, g, sq, dv)
    s = q @ k.transpose(-1, -2)
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    p = torch.where(mask, torch.exp(s - lse.reshape(bhkv, g, sq, 1)), 0.0)
    delta = (do * o.float().reshape(bhkv, g, sq, dv)).sum(-1, keepdim=True)
    ds = p * (do @ v.transpose(-1, -2) - delta)
    if softcap is not None:
        ds = ds * (1 - t * t)
    p, ds = (x.to(torch.bfloat16).float() for x in (p, ds))
    grad_v = (p.transpose(-1, -2) @ do).sum(1)
    grad_q = (ds @ k).reshape(bhg, sq, dk)
    grad_k = (ds.transpose(-1, -2) @ q).sum(1)
    return (grad_q.to(q2.dtype), grad_k.to(k2.dtype), grad_v.to(v2.dtype),
            None, None, None, None)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("python tools/grad_gate_control.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cs.phase_environment()
    cs.phase_build()
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    dev = torch.device("cuda", 0)
    cfg = get_config(cs.ARCH)
    params = init_params(cfg, 0, device=dev)
    toks = cs.family_inputs(cfg, cs.TRAIN_S + 1, dev, seed=3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    plain = cs.model_grads(cfg, params, batch, "ref")
    out = {"limits": {"loss_rel_err": cs.GRAD_LOSS_RTOL,
                      "grad_norm_rel_err": cs.GRAD_NORM_RTOL,
                      "min_cosine": cs.GRAD_MIN_COS}}
    for name, backward in (("kernel", KERNEL_BACKWARD),
                           ("bf16_p_and_ds", bf16_ds_backward)):
        FlashAttention.backward = staticmethod(backward)
        rec = cs.grad_gap(cs.model_grads(cfg, params, batch, None), plain)
        FlashAttention.backward = staticmethod(KERNEL_BACKWARD)
        rec["passes_gate"] = cs.grad_gate_passes(rec)
        out[name] = rec
        print(f"[control] {name}: loss {rec['loss_rel_err']:.3e}, grad norm "
              f"{rec['grad_norm_rel_err']:.3e}, lowest leaf cosine "
              f"{rec['min_cosine']:.6f} ({rec['min_cosine_leaf']}); passes "
              f"the gate: {rec['passes_gate']}", flush=True)
    cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = cs.OUT_DIR / "grad_gate_control.json"
    path.write_text(json.dumps(out, indent=1, default=str))
    print(f"[done] {path}")


if __name__ == "__main__":
    main()

"""Train the reference's "100M" LM for a few hundred steps.

    python -m repro_torch.examples.train_lm [--steps 200] [--device cpu]

Twin of the reference's ``examples/train_lm.py``: its "~100M-parameter"
gemma3-family config (real vocab 32,768, 6 layers of the 5:1 local:global
pattern, head dim 64), registered the way the reference registers it (the
gemma3-1b module's ``make_config`` swapped for the run), streamed from the
deterministic synthetic pipeline through the port's ``train`` (the flash
kernels forward and backward on the card), with async checkpointing into
a temporary directory, removed afterwards.  It prints the loss curve and,
at 100 steps or more, asserts that the loss fell, as the reference does.
"""
from __future__ import annotations

import argparse
import tempfile

from .. import configs
from ..configs import gemma3_1b as g3
from ..device import DeviceLike, resolve_device
from ..launch import train as T
from ..models.config import AttentionConfig, BlockSpec, ModelConfig, Stage

__all__ = ["main", "make_100m"]


def make_100m() -> ModelConfig:
    local = AttentionConfig(n_heads=4, n_kv_heads=1, head_dim=64,
                            rope_theta=10_000.0, sliding_window=256)
    glob = AttentionConfig(n_heads=4, n_kv_heads=1, head_dim=64,
                           rope_theta=1_000_000.0)
    period = tuple([BlockSpec("attn", "mlp", attn_override=local)] * 5
                   + [BlockSpec("attn", "mlp", attn_override=glob)])
    return ModelConfig(
        name="gemma3-100m", family="dense", d_model=512,
        vocab_size=32_768, d_ff=2048, attention=glob,
        stages=(Stage(1, period),), tie_embeddings=True, act="gelu",
        subquadratic=True,
    )


def main(device: DeviceLike = None, *, steps: int = 200, batch: int = 8,
         seq: int = 256, log_every: int = 10) -> dict:
    device = resolve_device(device)
    cfg = make_100m()
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{cfg.n_layers} layers")

    # register the config so the standard driver can resolve it
    configs._MODULES["gemma3-100m"] = "gemma3_1b"
    orig = g3.make_config
    g3.make_config = make_100m
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = T.train("gemma3-100m", smoke=False, steps=steps,
                          global_batch=batch, seq_len=seq,
                          ckpt_dir=tmp, ckpt_every=50,
                          peak_lr=3e-4, log_every=log_every, device=device)
    finally:
        g3.make_config = orig
        configs._MODULES.pop("gemma3-100m", None)
    print(f"\nfirst loss {out['first_loss']:.3f} -> "
          f"final loss {out['final_loss']:.3f} "
          f"({out['tok_per_s']:.0f} tok/s on {device})")
    if steps >= 100:  # warmup dominates shorter runs
        assert out["final_loss"] < out["first_loss"], "loss must decrease"
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(a.device, steps=a.steps, batch=a.batch, seq=a.seq)

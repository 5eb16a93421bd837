"""One model phase of ``chip_smoke.py`` alone, to iterate on it.

    python tools/model_phase.py {model,families,recurrent,training,mesh,
                                 roofline}

runs the smoke's environment and build phases, then ``phase_model``
(gemma3-1b), ``phase_model_families`` (deepseek-moe-16b, deepseek-v3 and
the dense and frontend configs), ``phase_recurrent_families`` (rwkv6-1.6b
and jamba's period) or ``phase_training`` (the flash backward kernel,
gemma3-1b's gradient and its training killed and resumed, MoE training,
the ``train_lm`` twin, the scans' backward kernels and rwkv6-1.6b's and
jamba's training) or ``phase_mesh`` (after the meshless steps it compares
with: gemma3-1b's first ``MESH_STEPS`` steps of phase 13's schedule) or
the mesh phase and then ``phase_roofline`` (the dry run held to the mesh
phase's counted step; its dry runs run in spawned processes, so this
script's work sits under its ``__main__`` guard) on
the card, with the smoke's settings, and writes
the phase's record to ``chiprun_out/<phase>.json``.  Needs a CUDA card and
``nvcc``; the recurrent phase takes some 2 minutes with the build.
"""
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402



def mesh_alone(dev):
    """``phase_mesh`` against gemma3-1b's meshless steps run here."""
    from repro_torch.launch.train import train
    torch.cuda.reset_peak_memory_stats()
    c = train(cs.ARCH, smoke=False, steps=cs.MESH_STEPS,
              global_batch=cs.TRAIN_B, seq_len=cs.TRAIN_S,
              peak_lr=cs.TRAIN_LR, log_every=1, total_steps=cs.TRAIN_STEPS,
              device=dev)
    training = {"train": {
        "losses": {"c": c["losses"]},
        "step_s_median": statistics.median(t for s, t in c["step_s"]
                                           if s > 0),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}}
    torch.cuda.empty_cache()
    return cs.phase_mesh(dev, training)


def roofline_alone(dev):
    """``phase_roofline`` after the mesh phase it reads."""
    card = cs.phase_environment()
    dry_runs = cs.start_dry_runs()
    mesh = mesh_alone(dev)
    return {"mesh": mesh, "roofline": cs.phase_roofline(
        card, mesh, cs.wait_dry_runs(dry_runs))}


PHASES = {"model": cs.phase_model, "families": cs.phase_model_families,
          "recurrent": cs.phase_recurrent_families,
          "training": cs.phase_training, "mesh": mesh_alone,
          "roofline": roofline_alone}


def main() -> None:
    name = sys.argv[1] if len(sys.argv) > 1 else "recurrent"
    if name not in PHASES or not torch.cuda.is_available():
        sys.exit(f"usage: python tools/model_phase.py {{{','.join(PHASES)}}} "
                 f"(on a CUDA card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cs.phase_environment()
    cs.phase_build()
    try:
        rec = PHASES[name](torch.device("cuda", 0))
    finally:
        cs.stop_children()
    cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
    (cs.OUT_DIR / f"{name}.json").write_text(json.dumps(rec, indent=1,
                                                       default=str))
    print(f"[done] {name}: {cs.OUT_DIR / f'{name}.json'}")


if __name__ == "__main__":
    main()

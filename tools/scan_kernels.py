"""The recurrent scan kernels alone on the card: build, check, time.

    python tools/scan_kernels.py

builds ``selective_scan`` and ``wkv6`` (``src/repro_torch/kernels/csrc``),
prints what ``nvcc -Xptxas=-v`` reported (registers, shared memory,
spills), holds each kernel against its plain version on random float32
operands from a seed, outputs and final states bit for bit, at a small
ragged shape and at 2,048 steps of the main path's width, then times each
kernel (CUDA events, median of 3) at the main path's 32k layer shape:
a jamba Mamba layer (B 1, S 32,768, Di 8,192, N 16) and an rwkv6-1.6b
layer (B 1, S 32,768, 32 heads of 64), beside ``chip_smoke.scan_bound``.
Needs a CUDA card and ``nvcc``; some 20 s with the build.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.selective_scan.ops import selective_scan  # noqa: E402
from repro_torch.kernels.wkv6.ops import wkv6  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("tools/scan_kernels.py needs a CUDA card")
cs.phase_environment()
_build.build(["selective_scan", "wkv6"])
for name in ("selective_scan", "wkv6"):
    for line in _build.compiler_report(name).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {name}: {line.strip()}")
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)


def rand(*shape):
    return torch.randn(*shape, device=dev, generator=gen)


def scan_operands(b, s, di, n):
    a = -torch.arange(1, n + 1, device=dev, dtype=torch.float32)
    return (rand(b, s, di), torch.nn.functional.softplus(rand(b, s, di) - 2),
            rand(b, s, n), rand(b, s, n), a.repeat(di, 1), rand(b, di, n))


def wkv_operands(b, s, h, hd):
    return (rand(b, s, h, hd) * 0.5, rand(b, s, h, hd) * 0.5,
            rand(b, s, h, hd) * 0.5,
            torch.exp(-torch.exp(rand(b, s, h, hd) - 2)),
            rand(h, hd) * 0.1, rand(b, h, hd, hd))


cases = (("selective_scan", selective_scan, scan_operands,
          ((2, 37, 200, 8), (1, 2048, 8192, 16)), (1, 32768, 8192, 16)),
         ("wkv6", wkv6, wkv_operands,
          ((2, 37, 3, 16), (1, 2048, 32, 64)), (1, 32768, 32, 64)))
for name, fn, operands, checks, layer in cases:
    for shape in checks:
        *ops, state = operands(*shape)
        s_k, s_r = state.clone(), state.clone()
        out_k, _ = fn(*ops, s_k)
        out_r, _ = fn(*ops, s_r, backend="ref")
        torch.cuda.synchronize()
        same = torch.equal(out_k, out_r) and torch.equal(s_k, s_r)
        print(f"[check] {name} {shape}: bit-equal to the plain version "
              f"{same}")
        if not same:
            sys.exit(f"{name} {shape}: the kernel differs from its plain "
                     f"version")
    args = operands(*layer)
    *ops, state = args
    ms = cs.cuda_time_ms(lambda: fn(*ops, state), reps=3)
    b_ms, b_by = cs.scan_bound(name, args)
    print(f"[time] {name} {layer}: {ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), {ms / b_ms:.1f}x")

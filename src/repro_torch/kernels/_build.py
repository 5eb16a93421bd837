"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into its own
shared library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o <name>-<hash>.so csrc/<name>.cu

The libraries go to ``build/repro_torch_kernels/`` at the root of the
checkout; ``<hash>`` is taken over the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  The compiler's
report (registers, spills) is kept beside each library as ``.log``.
:func:`build` starts one ``nvcc`` per source, all at once.  A build that
fails raises: nothing falls back to the plain version.

Nothing here runs at import: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["KERNELS", "build", "load", "compiler_report"]

#: every CUDA source of the port, by kernel name
KERNELS = ("uts_hash", "mandelbrot", "flash_attention",
           "flash_attention_bwd", "bc_level", "selective_scan",
           "selective_scan_bwd", "wkv6", "wkv6_bwd")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_CSRC = Path(__file__).resolve().parent / "csrc"
_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _build_dir() -> Path:
    """``build/repro_torch_kernels`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _source(name: str) -> Path:
    if name not in KERNELS:
        raise ValueError(f"unknown kernel source {name!r}; have {KERNELS}")
    return _CSRC / f"{name}.cu"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under /usr/local/cuda/bin); "
            "the port's CUDA kernels are built on the machine with the card")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(_source(name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet.

    Starts one ``nvcc`` per missing library at once and waits for all of
    them.  Returns ``{name: seconds}`` for the sources it compiled (the
    wall time of the whole parallel build); raises ``RuntimeError`` with
    the compiler's output if any of them fails.
    """
    names = list(KERNELS if names is None else names)
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    _build_dir().mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    procs = {}
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_source(n))]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        _target(n).with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    dt = time.monotonic() - t0
    return {n: dt for n in todo}


def compiler_report(name: str) -> str:
    """What ``nvcc -Xptxas=-v`` said when ``name`` was built ('' if unknown)."""
    log = _target(name).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib

"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles, on its
own ``nvcc`` process, into ``build/repro_torch/lib<name>-<hash>.so`` at
the repository root; the hash covers the source, the ``csrc/`` headers it
includes (``#include "..."``, recursively) and the flags, so a library is
rebuilt when any of them changes, and only then. All stale libraries
build at once, in parallel, at the first kernel launch (or through
:func:`build_all`). Nothing here runs at import time: the CPU tests
import every module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

KERNELS = ("codes", "conv_pipe", "decode_attention", "flash_attention",
           "lrn_pwl", "matmul_pipe")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on ``PATH``, else ``$CUDA_HOME/bin`` (CUDA_HOME
    defaulting to /usr/local/cuda, as PyTorch's own builder does)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or in $CUDA_HOME/bin: the CUDA kernels of "
        "repro_torch are built from source at first use; install the CUDA "
        "toolkit or set CUDA_HOME, or run on CPU tensors (plain versions)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: List[Path]) -> List[Path]:
    """``path`` and every header it includes with quotes, found beside it,
    depth first, each once."""
    if path not in seen:
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            _sources(path.parent / inc.decode(), seen)
    return seen


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where kernel ``name``'s library lives: keyed by a hash of its
    source, the headers it includes, and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(csrc / f"{name}.cu", []):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The card's SM count, which the tile and split rules read on every
    launch; queried once a device."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def build_all() -> Dict[str, dict]:
    """Compile every stale kernel library, one nvcc per source, all
    started together. Returns ``{name: {"seconds", "ptxas", "cached"}}``
    (ptxas' register/spill report from ``-Xptxas -v``); raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # repro: allow[RPA102] build time is reported, never fed to a clock
    t0 = time.perf_counter()
    procs = {}
    out: Dict[str, dict] = {}
    for name in KERNELS:
        lib = library_path(name)
        log = lib.with_suffix(".log")
        if lib.is_file():
            out[name] = {"seconds": 0.0, "cached": True,
                         "ptxas": log.read_text() if log.is_file() else ""}
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, log)
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n{text}")
            continue
        log.write_text(text)
        os.replace(tmp, lib)             # atomic: concurrent builders agree
        # repro: allow[RPA102] build time is reported, never fed to a clock
        out[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                     "ptxas": text}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building stale ones first."""
    if name not in _LIBS:
        lib = library_path(name)
        if not lib.is_file():
            build_all()
        _LIBS[name] = ctypes.CDLL(str(lib))
    return _LIBS[name]

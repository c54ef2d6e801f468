"""Build the CUDA sources under ``repro_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/<name>-<hash>.so`` at the repo root, where the hash covers
the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. The library is loaded with ``ctypes``;
each kernel module declares its function's argument types.

Nothing here runs at import time: a kernel is built the first time its
wrapper launches it (or when ``build`` is called for all of them at
once, one ``nvcc`` per source, all started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("admm_update", "prox_update", "logreg_grad", "flash_attention")

# IEEE division and no fast math: the kernels must agree with their plain
# torch versions (see the notes at the top of each source).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are built from source at first use")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source in ``names`` that has no library yet, all
    nvcc processes at once; returns each library's path. A failed build
    raises with nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = {}
    try:
        for name, path in paths.items():
            if path.exists():
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT),
                           tmp)
        failures = []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed on csrc/{name}.cu "
                                f"(exit {proc.returncode}):\n"
                                f"{out.decode(errors='replace')}")
            else:
                os.replace(tmp, paths[name])
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib

"""Build and load the port's CUDA kernels (``nvcc`` + ``ctypes``).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``build/repro_torch/lib<name>-<hash>.so`` at the root of
the checkout, where ``<hash>`` covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded as it is; the build's ``nvcc`` output is
kept beside it as ``lib<name>-<hash>.log``. A missing ``nvcc`` or a
failed build raises; nothing falls back.

``build_all()`` starts one ``nvcc`` per source at once, so the build
time of several kernels is that of the slowest.
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
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ``nvcc`` output (``-Xptxas -v``: registers, shared memory, spills) per
#: kernel built or loaded from ``build/`` by ``build_all`` (where its log was
#: kept), and seconds per kernel built by this process.
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the port's CUDA kernels are built on the machine with the GPU"
        )
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    proc.tmp_path = tmp  # type: ignore[attr-defined]
    return proc


def _finish(name: str, out: Path, proc: subprocess.Popen, t0: float) -> None:
    log, _ = proc.communicate()
    build_logs[name] = log
    build_seconds[name] = time.perf_counter() - t0
    tmp = proc.tmp_path  # type: ignore[attr-defined]
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Build every named kernel (default: all of ``csrc/``) in parallel."""
    names = sources() if names is None else list(names)
    with _lock:
        paths = {name: library_path(name) for name in names}
        t0 = time.perf_counter()
        procs = {
            name: _start(name, path)
            for name, path in paths.items() if not path.exists()
        }
        for name, path in paths.items():
            saved = path.with_suffix(".log")
            if name not in procs and saved.exists():
                build_logs[name] = saved.read_text()
        errors = []
        for name, proc in procs.items():
            try:
                _finish(name, paths[name], proc, t0)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib

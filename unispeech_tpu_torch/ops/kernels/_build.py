"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

All of ``unispeech_tpu_torch/csrc/*.cu`` go into one shared library with a
plain C interface. It is built at the first kernel call (never on import),
one nvcc process per source, all started together, then linked; the result
lands in ``unispeech_tpu_torch/_build/`` under a name that carries the hash
of the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Optional, Sequence

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_functions: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libunispeech_kernels_{h.hexdigest()[:16]}.so"


def build_log_path() -> pathlib.Path:
    return library_path().with_suffix(".log")


def build() -> pathlib.Path:
    """Compile and link the library unless it exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    work = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for cmd, _, p in procs:
        text, _ = p.communicate()
        log.append(" ".join(cmd) + "\n" + text)
        if p.returncode != 0:
            failed.append(text)
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp_lib = work / out.name
    link = [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    log.append(" ".join(link) + "\n" + res.stdout)
    if res.returncode != 0:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError("nvcc link failed:\n" + res.stdout)
    (work / "build.log").write_text("\n".join(log))
    os.replace(work / "build.log", build_log_path())
    os.replace(tmp_lib, out)  # atomic: a concurrent loader sees all or none
    shutil.rmtree(work, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.usk_error_string.argtypes = [ctypes.c_int]
            lib.usk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``name`` with its argument types declared; every entry
    returns the launch's cudaError_t."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def launch(fn: ctypes._CFuncPtr, name: str, device: torch.device, *args) -> None:
    """Call the C entry with ``device`` current (its kernel launches there)
    and raise if the launch failed."""
    with torch.cuda.device(device):
        err = fn(*args)
    if err != 0:
        msg = library().usk_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, what: str) -> None:
    """Raise for an input the kernel does not take."""
    if not cond:
        raise ValueError(what)


# the dtypes the kernels compute in: bf16, and fp32 (the models' default)
COMPUTE_DTYPES = (torch.bfloat16, torch.float32)

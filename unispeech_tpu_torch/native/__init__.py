"""ctypes loader of the host kernels in ``packer.cpp``.

The library is built with ``g++`` at the first call (never on import) into
``unispeech_tpu_torch/_build/``, under a name that carries the hash of the
source and flags; a build writes a temporary file and renames it into
place, so processes that build at once do not clash. A failed build
raises. ``data/batching.py`` and ``decode/wer.py`` call these kernels; their
Python scans (``batch_by_size_plain``, ``edit_distance_plain``) are the
plain versions the tests hold them to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import List, Sequence

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "packer.cpp"
BUILD_DIR = SOURCE.parents[1] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libunispeech_native_{h}.so"


def build() -> pathlib.Path:
    """Compile the library unless it exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed:\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, p64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
            p32 = ctypes.POINTER(ctypes.c_int32)
            lib.batch_by_size_vec.restype = i64
            lib.batch_by_size_vec.argtypes = [p64, i64, i64, i64, i64, p64]
            lib.edit_distance.restype = i64
            lib.edit_distance.argtypes = [p32, i64, p32, i64]
            lib.edit_distance_batch.restype = None
            lib.edit_distance_batch.argtypes = [p32, p64, p64, p32, p64, p64, i64, p64]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def batch_by_size_native(sizes: np.ndarray, max_tokens: int, max_sentences: int,
                         bsz_mult: int) -> List[int]:
    """The end offsets of the batches the packer closes."""
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    ends = np.empty(len(sizes) + 1, dtype=np.int64)
    n = get_lib().batch_by_size_vec(_ptr(sizes, ctypes.c_int64), len(sizes), max_tokens,
                                    max_sentences, bsz_mult, _ptr(ends, ctypes.c_int64))
    return ends[:n].tolist()


def edit_distance_native(a: Sequence[int], b: Sequence[int]) -> int:
    aa = np.ascontiguousarray(a, dtype=np.int32)
    bb = np.ascontiguousarray(b, dtype=np.int32)
    return int(get_lib().edit_distance(_ptr(aa, ctypes.c_int32), len(aa),
                                       _ptr(bb, ctypes.c_int32), len(bb)))


def edit_distance_batch_native(pairs: Sequence) -> np.ndarray:
    """Distances of (a, b) int sequence pairs in one call."""
    def flat(seqs):
        lens = np.asarray([len(s) for s in seqs], np.int64)
        offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
        data = np.ascontiguousarray(np.concatenate([np.asarray(s, np.int32) for s in seqs])
                                    if len(seqs) else np.zeros(0, np.int32), np.int32)
        return data, lens, offs

    (ad, al, ao), (bd, bl, bo) = flat([p[0] for p in pairs]), flat([p[1] for p in pairs])
    out = np.empty(len(pairs), np.int64)
    get_lib().edit_distance_batch(_ptr(ad, ctypes.c_int32), _ptr(al, ctypes.c_int64),
                                  _ptr(ao, ctypes.c_int64), _ptr(bd, ctypes.c_int32),
                                  _ptr(bl, ctypes.c_int64), _ptr(bo, ctypes.c_int64),
                                  len(pairs), _ptr(out, ctypes.c_int64))
    return out

"""The native block reader of ``.npy`` files.

Port of ``pydnmfk_tpu/native/``: ``blockio.c`` (a copy of the JAX
package's) reads one row-range x column-range block of a row-major matrix
with one ``pread`` per row, so that a rank of a grid touches only its
block's bytes, where the reference reads the whole file on every rank
(pyDNMFk/data_io.py:92-105). :func:`read_npy_block` parses the ``.npy``
header here and hands the byte offsets to C.

The library is built at first use, never at import, with the system C
compiler (``$CC``, else ``cc``, ``gcc`` or ``clang``) into
``build/pydnmfk_tpu_torch/`` at the root of the checkout, named by a hash
of the source and the flags, as ``ops/cuda_lib.py`` builds the kernels.
Where no compiler builds it, :func:`get_lib` warns once and returns None,
and ``utils/io.py::DataReader`` slices a numpy memory map instead.
``READS`` counts the blocks that each path served.
"""
from __future__ import annotations

import ast
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "blockio.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pydnmfk_tpu_torch"
CC_FLAGS = ("-O2", "-shared", "-fPIC")
# blocks served: by the C reader, and by the numpy memory map where it could
# not serve them (no compiler, or a layout it does not read)
READS = {"native": 0, "mmap": 0}

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"blockio-{digest[:16]}.so"


def _build(out: Path) -> bool:
    """Compiles ``blockio.c`` into ``out`` with the first compiler that
    succeeds; False where none does."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    for cc in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if not cc or shutil.which(cc) is None:
            continue
        try:
            proc = subprocess.run([cc, *CC_FLAGS, str(SRC), "-o", str(tmp)],
                                  capture_output=True, timeout=60)
        except subprocess.TimeoutExpired:
            continue
        if proc.returncode == 0:
            os.replace(tmp, out)      # atomic: a concurrent rank loads a
            return True               # whole file
    return False


def get_lib():
    """The ctypes handle of the block reader, built at first use; None
    (after one warning) where no C compiler builds it."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not out.exists() and not _build(out):
            warnings.warn(
                "no C compiler built pydnmfk_tpu_torch/native/blockio.c "
                "(set CC): block reads of .npy files slice a numpy memory "
                "map instead")
            return None
        lib = ctypes.CDLL(str(out))
        lib.read_block.restype = ctypes.c_int
        lib.read_block.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        _lib = lib
        return _lib


def parse_npy_header(path: str):
    """(dtype, shape, data offset) of a C-order little-endian ``.npy``
    file, or None for a layout the reader does not take (Fortran order,
    objects, big-endian)."""
    with open(path, "rb") as f:
        if f.read(6) != b"\x93NUMPY":
            return None
        major, _minor = f.read(2)
        if major == 1:
            (hlen,) = np.frombuffer(f.read(2), "<u2")
        else:
            (hlen,) = np.frombuffer(f.read(4), "<u4")
        header = f.read(int(hlen)).decode("latin1")
        offset = f.tell()
    d = ast.literal_eval(header)
    if d.get("fortran_order"):
        return None
    dt = np.dtype(d["descr"])
    if dt.hasobject or dt.byteorder == ">":
        return None
    return dt, tuple(d["shape"]), offset


def read_npy_block(path: str, row_start: int, row_stop: int,
                   col_start: int, col_stop: int):
    """Rows [row_start, row_stop) x columns [col_start, col_stop) of a 2-D
    ``.npy`` matrix, reading only their bytes; None where the native
    reader cannot (no compiler, or a layout it does not take), and the
    caller falls back to numpy."""
    lib = get_lib()
    info = parse_npy_header(path)
    if lib is None or info is None or len(info[1]) != 2:
        return None
    dt, (m, n), offset = info
    row_stop, col_stop = min(row_stop, m), min(col_stop, n)
    nrows, ncols = row_stop - row_start, col_stop - col_start
    out = np.empty((nrows, ncols), dtype=dt)
    offset0 = offset + (row_start * n + col_start) * dt.itemsize
    rc = lib.read_block(str(path).encode(), offset0, n * dt.itemsize,
                        ncols * dt.itemsize, nrows,
                        out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        return None
    READS["native"] += 1
    return out

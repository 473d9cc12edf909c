"""ctypes bindings for the native host-side compat kernels.

The strictly-sequential int16-feedback kernels (GEQ cascade, per-sample
NLMS, block NLMS) need per-operation f64 rounding; XLA's fused loops
contract mul+add into fma, which flips truncation boundaries (see
ops/geq.py).  These kernels are therefore compiled from
``native/jeicyboo_native.cpp`` with ``-ffp-contract=off`` and loaded here.
The library builds lazily on first use and falls back gracefully (callers
check ``available()``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "jeicyboo_native.cpp")
_LIB = os.path.join(_ROOT, "native", "build", "libjeicyboo_native.so")

_lock = threading.Lock()
_lib = None
_tried = False

_I16P = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _build() -> bool:
    """Compile to a private file, then rename it into place: processes that
    build concurrently (test workers) never load a half-written library."""
    import tempfile

    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_LIB))
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-ffp-contract=off", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            if not _build():
                return None
        lib = ctypes.CDLL(_LIB)
        lib.jb_geq_process.argtypes = [
            _I16P, ctypes.c_int64, _F64P, _F64P, _I16P, _I16P, _I16P,
        ]
        lib.jb_nlms_process.argtypes = [
            _I16P, _I16P, ctypes.c_int64, _F64P, _I16P, _I16P, _I16P,
        ]
        lib.jb_bnlms_process.argtypes = [
            _I16P, _I16P, ctypes.c_int64, _F64P, _I16P, _I16P, _I16P, _I16P,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def geq_process(x, b, a, keep_in, keep_out):
    """Run the exact compat GEQ cascade over int16 samples.

    Mutates keep_in/keep_out (7, 2) int16 state in place; returns out.
    """
    lib = _load()
    x = np.ascontiguousarray(x, np.int16)
    out = np.empty_like(x)
    lib.jb_geq_process(
        x,
        len(x),
        np.ascontiguousarray(b, np.float64),
        np.ascontiguousarray(a, np.float64),
        keep_in.reshape(-1),
        keep_out.reshape(-1),
        out,
    )
    return out


def nlms_process(x, ref, coeff, keep):
    """Exact per-sample NLMS over whole blocks (n*1024 samples)."""
    lib = _load()
    x = np.ascontiguousarray(x, np.int16)
    ref = np.ascontiguousarray(ref, np.int16)
    assert len(x) % 1024 == 0 and len(x) == len(ref)
    est = np.empty_like(x)
    err = np.empty_like(x)
    lib.jb_nlms_process(x, ref, len(x) // 1024, coeff, keep, est, err)
    return est, err


def bnlms_process(x, ref, coeff, keep_in, keep_ref):
    lib = _load()
    x = np.ascontiguousarray(x, np.int16)
    ref = np.ascontiguousarray(ref, np.int16)
    assert len(x) % 1024 == 0 and len(x) == len(ref)
    est = np.empty_like(x)
    err = np.empty_like(x)
    lib.jb_bnlms_process(x, ref, len(x) // 1024, coeff, keep_in, keep_ref, est, err)
    return est, err

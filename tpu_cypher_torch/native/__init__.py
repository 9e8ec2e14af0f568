"""Native host tier: C++ hot paths behind ctypes, with NumPy fallbacks.

The port of ``tpu_cypher/native/__init__.py``. ``csr_builder.cpp`` (a copy
of the reference's source) compiles on first use with the system ``g++``
(``-O3 -shared -fPIC -std=c++17``; a plain C ABI, so ctypes needs nothing
else) into ``tpu_cypher_torch/_build/native-<hash of source and
flags>/``, never beside the source: an edited source rebuilds, and a
checkout's package directory stays as git has it.

When ``g++`` is missing or refuses the source, ``get_lib()`` returns None
and every caller takes its NumPy path, as in the reference: the answers
are the same, only slower. ``build_error()`` then says why, so a caller
that needs the library (``chip_smoke.py`` on the card's machine) can
report the failure instead of carrying on quietly.

Callers: ``io.edge_list.load_edge_list`` (``parse_edge_list_native``) and
``backend.cuda.kernels.CsrGraph.build`` (``build_csr_native``). The three
count functions (``two_hop_distinct_native``, ``two_hop_close_count_native``,
``varlen_count_native``) keep the reference's signatures, but no operator
calls them: the reference runs them only where its device is the CPU, and
the port's CPU path is the card's path (ROADMAP.md section 3).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csr_builder.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(_HERE), "_build")

CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def build_dir() -> str:
    """Where this source and these flags build: ``_build/native-<hash>``."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, "native-" + h.hexdigest()[:16])


def lib_path() -> str:
    return os.path.join(build_dir(), "libcsr_builder.so")


def _compile(out: str) -> Optional[str]:
    """Build the library at ``out``; None on success, else why not. The
    compiler writes a temporary file in the same directory, renamed into
    place, so a concurrent loader never opens a half-written library."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        res = subprocess.run(
            ["g++", *CXX_FLAGS, _SRC, "-o", tmp],
            capture_output=True,
            text=True,
            timeout=120,
        )
        if res.returncode != 0:
            return f"g++ exited {res.returncode}: {res.stderr.strip()[-2000:]}"
        os.replace(tmp, out)
        return None
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"g++ could not run: {exc}"
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def build_error() -> Optional[str]:
    """Why the library is unavailable (after a ``get_lib()`` that returned
    None), else None."""
    return _build_error


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, compiled on demand; None if unavailable."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        path = lib_path()
        if not os.path.exists(path):
            err = _compile(path)
            if err is not None:
                _build_error = err
                return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            _build_error = f"could not load {path}: {exc}"
            return None
        p32 = ctypes.POINTER(ctypes.c_int32)
        p64 = ctypes.POINTER(ctypes.c_int64)
        pu8 = ctypes.POINTER(ctypes.c_uint8)
        lib.parse_edge_list.restype = ctypes.c_int64
        lib.parse_edge_list.argtypes = [ctypes.c_char_p, ctypes.c_int64, p64, p64]
        lib.unique_sorted.restype = ctypes.c_int64
        lib.unique_sorted.argtypes = [p64, ctypes.c_int64, p64]
        lib.build_csr.restype = ctypes.c_int32
        lib.build_csr.argtypes = [p64, ctypes.c_int64, p64, p64, ctypes.c_int64, p32, p32, p32]
        lib.two_hop_distinct.restype = ctypes.c_int64
        lib.two_hop_distinct.argtypes = [
            p32, p32, p32, p32, p64, p64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, pu8, pu8,
        ]
        lib.two_hop_close_count.restype = ctypes.c_int64
        lib.two_hop_close_count.argtypes = [
            p32, p32, p32, p32, p32, p32, p64, p64,
            ctypes.c_int64, ctypes.c_int64, pu8, pu8,
        ]
        lib.varlen_count.restype = ctypes.c_int64
        lib.varlen_count.argtypes = [
            p32, p32, p64, p64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, pu8,
        ]
        lib.varlen_count_forbid.restype = ctypes.c_int64
        lib.varlen_count_forbid.argtypes = [
            p32, p32, p64, p64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, pu8,
            p64, ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _p32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def parse_edge_list_native(data: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Parse a SNAP-style edge-list buffer; None if the native lib is
    unavailable. Raises ValueError on malformed input (byte offset in the
    message), as strict as the Python loader."""
    lib = get_lib()
    if lib is None:
        return None
    max_edges = data.count(b"\n") + 1
    src = np.empty(max_edges, dtype=np.int64)
    dst = np.empty(max_edges, dtype=np.int64)
    n = lib.parse_edge_list(data, len(data), _p64(src), _p64(dst))
    if n < 0:
        off = -int(n) - 1
        line = data[:off].count(b"\n") + 1
        raise ValueError(f"line {line} (byte offset {off})")
    return src[:n].copy(), dst[:n].copy()


def _csr32(rp, ci) -> Tuple[np.ndarray, np.ndarray]:
    return (
        np.ascontiguousarray(rp, dtype=np.int32),
        np.ascontiguousarray(ci, dtype=np.int32),
    )


def _mask_u8(mask) -> Optional[np.ndarray]:
    if mask is None:
        return None
    return np.ascontiguousarray(mask, dtype=np.uint8)


def _pm(m: Optional[np.ndarray]):
    return m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if m is not None else None


def _grouped(ak: np.ndarray) -> bool:
    """True when equal values are contiguous (each source forms one run),
    the stamping kernels' precondition."""
    if len(ak) < 2:
        return True
    changes = int(np.count_nonzero(ak[1:] != ak[:-1]))
    return changes == len(np.unique(ak)) - 1


def two_hop_distinct_native(
    rp1, ci1, rp2, ci2, frontier, akeys, n, use_a, use_c, mask1, mask2
) -> Optional[int]:
    """Stamped 2-hop DISTINCT-endpoints count (see csr_builder.cpp); None
    when the native lib is unavailable, when neither endpoint is counted
    (the kernel would count per frontier row, not per global row) or when
    equal akeys are not contiguous."""
    lib = get_lib()
    if lib is None:
        return None
    if not use_a and not use_c:
        return None
    ak = np.ascontiguousarray(akeys, dtype=np.int64)
    if not _grouped(ak):
        return None
    fr = np.ascontiguousarray(frontier, dtype=np.int64)
    rp1, ci1 = _csr32(rp1, ci1)
    rp2, ci2 = _csr32(rp2, ci2)
    m1, m2 = _mask_u8(mask1), _mask_u8(mask2)
    return int(
        lib.two_hop_distinct(
            _p32(rp1), _p32(ci1), _p32(rp2), _p32(ci2), _p64(fr), _p64(ak),
            len(fr), int(n), int(use_a), int(use_c), _pm(m1), _pm(m2),
        )
    )


def two_hop_close_count_native(
    rp1, ci1, rp2, ci2, rpc, cic, frontier, akeys, n, mask1, mask2
) -> Optional[int]:
    """Stamped 2-hop + close-probe count (see csr_builder.cpp); None when
    unavailable or equal akeys are not contiguous."""
    lib = get_lib()
    if lib is None:
        return None
    ak = np.ascontiguousarray(akeys, dtype=np.int64)
    if not _grouped(ak):
        return None
    fr = np.ascontiguousarray(frontier, dtype=np.int64)
    rp1, ci1 = _csr32(rp1, ci1)
    rp2, ci2 = _csr32(rp2, ci2)
    rpc, cic = _csr32(rpc, cic)
    m1, m2 = _mask_u8(mask1), _mask_u8(mask2)
    return int(
        lib.two_hop_close_count(
            _p32(rp1), _p32(ci1), _p32(rp2), _p32(ci2), _p32(rpc), _p32(cic),
            _p64(fr), _p64(ak), len(fr), int(n), _pm(m1), _pm(m2),
        )
    )


def varlen_count_native(
    rp, ci, eo, frontier, lo, hi, far_mask, forbid=None
) -> Optional[int]:
    """Bounded var-length walk count via the DFS kernel (see
    csr_builder.cpp); None when the native lib is unavailable or the bound
    is out of the kernel's stack range. ``forbid``: optional [nf, k] int64
    canonical scan rows each frontier row's walks must avoid (-1 pads)."""
    lib = get_lib()
    if lib is None:
        return None
    rp, ci = _csr32(rp, ci)
    eo = np.ascontiguousarray(eo, dtype=np.int64)
    fr = np.ascontiguousarray(frontier, dtype=np.int64)
    m = _mask_u8(far_mask)
    if forbid is not None:
        fb = np.ascontiguousarray(forbid, dtype=np.int64)
        if fb.ndim != 2 or fb.shape[0] != len(fr):
            return None
        got = int(
            lib.varlen_count_forbid(
                _p32(rp), _p32(ci), _p64(eo), _p64(fr),
                len(fr), int(lo), int(hi), _pm(m),
                _p64(fb), int(fb.shape[1]),
            )
        )
        return None if got < 0 else got
    got = int(
        lib.varlen_count(
            _p32(rp), _p32(ci), _p64(eo), _p64(fr),
            len(fr), int(lo), int(hi), _pm(m),
        )
    )
    return None if got < 0 else got


def build_csr_native(
    node_ids: np.ndarray, src: np.ndarray, dst: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """(unique_ids, row_ptr, col_idx, src_idx) lexsorted by (src, dst), or
    None if the native lib is unavailable. Raises ValueError when an edge
    endpoint is not among ``node_ids``."""
    lib = get_lib()
    if lib is None:
        return None
    ids = np.ascontiguousarray(node_ids, dtype=np.int64)
    uniq = np.empty(len(ids), dtype=np.int64)
    n = lib.unique_sorted(_p64(ids), len(ids), _p64(uniq))
    uniq = uniq[:n].copy()
    s = np.ascontiguousarray(src, dtype=np.int64)
    d = np.ascontiguousarray(dst, dtype=np.int64)
    e = len(s)
    row_ptr = np.empty(n + 1, dtype=np.int32)
    col_idx = np.empty(e, dtype=np.int32)
    src_idx = np.empty(e, dtype=np.int32)
    rc = lib.build_csr(
        _p64(uniq), n, _p64(s), _p64(d), e, _p32(row_ptr), _p32(col_idx), _p32(src_idx)
    )
    if rc != 0:
        raise ValueError("Edge endpoint id not present in node_ids")
    return uniq, row_ptr, col_idx, src_idx

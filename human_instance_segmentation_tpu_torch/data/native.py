"""ctypes loader for the native mask codecs (``_native/rle.cpp``).

The shared object is compiled with ``g++ -O3 -shared -fPIC`` at first use,
into ``build/native/`` at the repository root (listed in .gitignore), under
a name that carries a hash of the source and the flags, so a changed source
builds anew and an unchanged one loads what is there. The wrappers take and
return numpy arrays with the JAX package's signatures. This is host code,
not a device kernel: where no toolchain exists, :func:`get_lib` returns
None, every wrapper returns None and ``coco.py`` runs its Python forms.
:func:`get_lib` (or :data:`build_error`) says which ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "_native" / "rle.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_lock = threading.Lock()
# why the native codec is not in use (None while it is, or before the first call)
build_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"librle_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile into a private name and rename it into place, so processes
    that build at the same time never load a half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, text=True, timeout=120)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built on first use; None if it cannot be
    built or loaded (callers then run the Python forms)."""
    global _lib, _load_failed, build_error
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = library_path()
        try:
            if not path.is_file():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None) or ""
            build_error = f"{type(e).__name__}: {e} {detail}".strip()
            _load_failed = True
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.rle_decode.argtypes = [i32p, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int]
        lib.rle_decode.restype = None
        lib.rle_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int]
        lib.rle_encode.restype = ctypes.c_int
        lib.leb_decode.argtypes = [u8p, ctypes.c_int, i32p, ctypes.c_int]
        lib.leb_decode.restype = ctypes.c_int
        lib.leb_encode.argtypes = [i32p, ctypes.c_int, u8p, ctypes.c_int]
        lib.leb_encode.restype = ctypes.c_int
        lib.rasterize_polygons.argtypes = [f64p, i32p, ctypes.c_int, u8p,
                                           ctypes.c_int, ctypes.c_int]
        lib.rasterize_polygons.restype = None
        _lib = lib
        return _lib


def rle_decode_native(counts: Sequence[int], h: int, w: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    c = np.ascontiguousarray(counts, np.int32)
    out = np.zeros((h, w), np.uint8)
    lib.rle_decode(c, len(c), out, h, w)
    return out


def rle_encode_native(mask: np.ndarray) -> Optional[List[int]]:
    lib = get_lib()
    if lib is None:
        return None
    m = np.ascontiguousarray(mask, np.uint8)
    h, w = m.shape
    out = np.zeros(h * w + 2, np.int32)
    n = lib.rle_encode(m, h, w, out, len(out))
    if n < 0:
        return None
    return out[:n].tolist()


def leb_decode_native(s: bytes) -> Optional[List[int]]:
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(s, np.uint8)
    out = np.zeros(max(len(s), 4), np.int32)
    n = lib.leb_decode(np.ascontiguousarray(buf), len(buf), out, len(out))
    if n < 0:
        return None
    return out[:n].tolist()


def leb_encode_native(counts: Sequence[int]) -> Optional[str]:
    lib = get_lib()
    if lib is None:
        return None
    c = np.ascontiguousarray(counts, np.int32)
    out = np.zeros(len(c) * 8 + 16, np.uint8)
    n = lib.leb_encode(c, len(c), out, len(out))
    if n < 0:
        return None
    return out[:n].tobytes().decode("ascii")


def rasterize_polygons_native(polygons: Sequence[Sequence[float]], h: int,
                              w: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    flat = []
    sizes = []
    for poly in polygons:
        npts = len(poly) // 2
        sizes.append(npts)
        flat.extend(poly[: 2 * npts])
    if not sizes:
        return np.zeros((h, w), np.uint8)
    xy = np.ascontiguousarray(flat, np.float64)
    ps = np.ascontiguousarray(sizes, np.int32)
    out = np.zeros((h, w), np.uint8)
    lib.rasterize_polygons(xy, ps, len(sizes), out, h, w)
    return out

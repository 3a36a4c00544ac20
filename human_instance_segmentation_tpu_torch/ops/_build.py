"""Build the hand-written CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` file of this package is compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` process per source, all started
together, and the objects are linked into one shared library with a plain
C interface, under ``build/kernels/`` at the repository root (listed in
.gitignore). The library's name carries a hash of the sources, the
headers (``csrc/*.cuh``) and the flags, so a changed source builds anew and
an unchanged one loads what is there. A missing ``nvcc`` or a failed build
raises: there is no fallback.

Nothing is built at import time; the first wrapper that launches a kernel
calls :func:`library`.

Every entry point that has a plain PyTorch twin asks :func:`takes_kernel`
whether to launch: a CPU tensor takes the twin, a CUDA tensor the kernel,
except inside :func:`plain`, where every entry point takes its twin on any
device (the plain path of the same graph, which a GPU run holds the
kernels against).
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterator, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Extra ``-D`` definitions (``NAME=VALUE``) of the build, empty for serving:
# scripts/profile_torch_kernels.py sets ``HIST_SKIP`` (parts switched off) or
# ``HIST_BF16_TILE`` (a forced wgmma tile) to build variants of the kernels,
# each under its own hashed name.
DEFINES: tuple = ()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_L = ctypes.c_longlong
# C signatures of the exported launchers; each returns cudaGetLastError().
SIGNATURES = {
    # x, w (HWIO, or null with wp), wp (bf16 K-major packed weights, or null), bytes per
    # packed row, b, gamma, beta, residual, out, scratch, N, H, W, Ci, Co, k, eps, relu,
    # dtype (0 f32, 1 bf16), stream
    "conv_ln_act_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _D, _I, _I, _P],
    # two maps, each: features, element strides (image, row, column, channel), C, out
    # (the second skipped when its C is 0); then rois (N, 5) f32, B, H, W, N, oh, ow, ssh,
    # ssw, aligned, dtype of both maps (0 f32, 1 bf16), stream
    "roi_align_launch": [_P, _L, _L, _L, _L, _I, _P, _P, _L, _L, _L, _L, _I, _P,
                         _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P],
    # x and its element strides as (N, C, H, W), packed weights, inv (1,),
    # qscale (Co,), b, gamma, beta, residual, out, scratch, int8 staging
    # buffer, N, H, W, Ci, Co, k, eps, relu, dtype (0 f32, 1 bf16), stream
    "conv_ln_act_s8_launch": [_P, _L, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _I, _I, _I, _I, _D, _I, _I, _P],
    # x and its element strides as (N, C, H, W), in dtype (0 f32, 1 bf16, 2 s8),
    # packed weights (Co, packed k), qparam (1,), qmode (0 divide, 1 multiply),
    # scale (Co,), bias or null, out (NHWC), out dtype (0 f32, 1 bf16, 2 s32),
    # int8 staging buffer or null, N, H, W, Ci, Co, k, pad, stream
    "s8_conv_launch": [_P, _L, _L, _L, _L, _I, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                       _I, _I, _I, _P],
    # x, its strides, in dtype, Ci, Co, k -> 1 when s8_conv_launch needs the
    # staging buffer (not a launcher)
    "s8_conv_needs_staging": [_P, _L, _L, _L, _L, _I, _I, _I, _I],
    # Ci, k -> bytes in one packed weight row (not a launcher)
    "s8_conv_packed_k": [_I, _I],
    # x (P, H, W) f32, out, P, H, W, k, a_s and a_r (log2(e) / (2 sigma^2) of the spatial
    # and the range Gaussian), stream
    "bilateral_filter_launch": [_P, _P, _I, _I, _I, _I, _F, _F, _P],
    # mask (P, H, W) f32, out, P, H, W, columns a lane (4 or 1), blur_strength, threshold,
    # stream
    "edge_smooth_launch": [_P, _P, _I, _I, _I, _I, _F, _F, _P],
    # float32: x and its element strides (batch, row, column, channel), w0 (9, Cip, Cp),
    # scale/shift 0 (2, Cp), w1 (9, Cp, Cp), scale/shift 1, head weights (9, Cp),
    # head bias (1,), out (B, 2h, 2w), B, h, w, Ci, Cip, Cp, stream
    "tail_launch": [_P, _L, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # Cp -> bytes of shared memory the float32 tail kernel needs (not a launcher)
    "tail_smem_bytes_for": [_I],
    # bfloat16: x and its element strides (batch, row, column, channel), w0, w1, wh, fp as
    # ops/cuda_tail.pack_tail_weights lays them out, out (B, 2h, 2w), B, h, w, Ci,
    # Cip / 16, Cp / 16, stream
    "tail_bf16_launch": [_P, _L, _L, _L, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # Cip / 16, Cp / 16 -> bytes of shared memory the bf16 tail kernel needs (not a launcher)
    "tail_bf16_smem_bytes_for": [_I, _I],
    # x and its element strides (batch, channel, row, column), we, be, wdw (k*k, Cm), bdw,
    # se (B, Cm), wp, bp, out and its strides, partial (B, tiles, Cm) f32, B, Ci, Cm, Co, H, W,
    # k, stride, residual, apply (0 sums pass, 1 apply pass), dtype (0 f32, 1 bf16), stream
    "mbconv_launch": [_P, _L, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _P,
                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # Ci, Co, k, stride, sizeof(T), expand, apply -> bytes of shared memory (not a launcher)
    "mbconv_smem_bytes_for": [_I, _I, _I, _I, _I, _I, _I],
    # Ho, Wo, stride, sizeof(T) -> tiles per image of pass 1, the middle extent of partial
    # (not a launcher)
    "mbconv_tiles_for": [_I, _I, _I, _I],
    # x and its element strides (batch, row, column, channel), in dtype (0 f32, 1 bf16, 2 s8),
    # float32(1 / s_x), s_x, w0 / w1 / wh codes and the float32 parameters as
    # ops/cuda_tail.pack_tail_weights_q lays them out, the bf16 border's w0, w1, wh, fp as
    # ops/cuda_tail.pack_tail_weights lays them out (null for a float32 output), out (B, 2h,
    # 2w), B, h, w, Ci, Cip, Cp, out dtype (0 f32, 1 bf16), stream
    "tail_q_launch": [_P, _L, _L, _L, _L, _I, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                      _I, _I, _I, _I, _I, _P],
    # Cip, Cp, border (1: the bf16 border in the kernel) -> bytes of shared memory the int8
    # tail kernel needs (not a launcher)
    "tail_q_smem_bytes_for": [_I, _I, _I],
    # the int8 tail's float32 border: x, its element strides, in dtype (0 f32, 1 bf16, 2 s8),
    # float32(1 / s_x), s_x, the float32 tail's operands as tail_launch takes them, out (B, 2h,
    # 2w), B, h, w, Ci, Cip, Cp, stream
    "tail_border_f32_launch": [_P, _L, _L, _L, _L, _I, _F, _F, _P, _P, _P, _P, _P, _P, _P, _I,
                               _I, _I, _I, _I, _I, _P],
    # x, residual or null and its element strides (N, C, H, W), 1 when they are x's, gamma,
    # beta, out, partial (N, P, 4) f32, stats (N, 2) f32 or null, N, C, H, W, channels_last,
    # P, values a block, form (0 channels-last vectors, 1 scalar), dtype
    # (0 f32, 1 bf16), int8 out, eps, relu, float32(1 / scale), stream
    "ln_act_launch": [_P, _P, _L, _L, _L, _L, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _L, _I, _I, _I, _F, _I, _F, _P],
}

_lib: Optional[ctypes.CDLL] = None
_lib_defines: tuple = ()
build_seconds: Optional[float] = None
build_log: str = ""


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _headers():
    return sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _flags():
    return (*NVCC_FLAGS, *(f"-D{d}" for d in DEFINES))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_flags()).encode())
    return BUILD_DIR / f"libhist_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if the library for their hash is missing."""
    global build_seconds, build_log
    out = library_path()
    if out.is_file():
        return out
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *_flags(), "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [(src, proc.returncode) for src, proc in zip(sources, procs) if proc.returncode]
    link = None
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed or link.returncode != 0:
        tmp.unlink(missing_ok=True)
        what = failed or [("link", link.returncode)]
        raise RuntimeError(f"nvcc failed {what}:\n{build_log}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (and again after
    :data:`DEFINES` changes)."""
    global _lib, _lib_defines
    if _lib is None or _lib_defines != DEFINES:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.hist_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hist_cuda_error_string.restype = ctypes.c_char_p
        _lib, _lib_defines = lib, DEFINES
    return _lib


def current_stream(device) -> int:
    """The raw handle of PyTorch's current CUDA stream on ``device``, for a
    launcher's ``stream`` argument."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # no Stream object is built
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = library().hist_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


_PLAIN = contextvars.ContextVar("plain", default=False)


@contextlib.contextmanager
def plain() -> Iterator[None]:
    """Inside the block every entry point with a plain twin computes the
    twin, on any device, and no hand kernel launches. Nested blocks restore
    the outer value."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def takes_kernel(t, name: str) -> bool:
    """Whether entry point ``name`` launches its kernel on tensor ``t``:
    False on the CPU and inside :func:`plain`, True on CUDA; any other
    device raises. Entry points call it through the module
    (``_build.takes_kernel(...)``, not a name imported from it), so that a
    test that substitutes it reaches every one."""
    kind = t.device.type
    if kind == "cpu" or _PLAIN.get():
        return False
    if kind != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {t.device}")
    return True

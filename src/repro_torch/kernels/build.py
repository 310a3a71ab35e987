"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc -c` process, all of them
started together, and the objects are linked into ONE shared library with a
plain C interface, loaded with `ctypes`.  No PyTorch headers are included,
so a build takes seconds, not minutes.  Target: `sm_90a` (Hopper).

The build runs at first use into `kernels/_build/` (listed in .gitignore),
named by a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.  Nothing here runs at import time: the
CPU tests import every module on a machine without `nvcc`.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None      # wall time of this process's build
ptxas_log: str = ""                     # registers / shared memory / spills


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return str(path)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    global build_seconds, ptxas_log
    t0 = time.perf_counter()
    nvcc = _nvcc()
    work = BUILD_DIR / f"obj-{target.stem}-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        procs = [(src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
             str(work / (src.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in sources()]
        logs, failed = [], []
        for src, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        ptxas_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{ptxas_log}")
        tmp = work / target.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *[str(work / (s.stem + ".o")) for s in sources()]],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed:\n{link.stdout}{link.stderr}")
        target.with_suffix(".ptxas.log").write_text(ptxas_log)
        os.replace(tmp, target)         # atomic against a concurrent builder
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet."""
    global _lib, ptxas_log
    with _lock:
        if _lib is None:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            target = BUILD_DIR / f"libreprotorch-{_digest()}.so"
            if not target.exists():
                _build(target)
            else:
                ptxas_log = target.with_suffix(".ptxas.log").read_text()
            lib = ctypes.CDLL(str(target))
            _declare(lib)
            _lib = lib
        return _lib


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes/restype of every exported function: each returns the
    `cudaError_t` of its launch (0 = success)."""
    lib.rmsnorm_f32.argtypes = [_P, _P, _P, _I, _I, _F, _P]
    lib.rmsnorm_bwd_f32.argtypes = [_P] * 6 + [_I, _I, _F, _I, _I, _P]
    lib.rmsnorm_bwd_grid.argtypes = [_I] * 3 + [ctypes.POINTER(_I)]
    lib.swiglu_f32.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
    lib.swiglu_fwd_pair_f32.argtypes = [_P] * 6 + [_I, _I, _I, _P]
    lib.swiglu_bwd_f32.argtypes = [_P] * 10 + [_I, _I, _I, _P]
    lib.swiglu_bwd_scratch_floats.argtypes = [_I, _I]
    lib.swiglu_bwd_scratch_floats.restype = _L
    lib.swiglu_tile_min_rows.argtypes = []
    lib.swiglu_tile_min_rows.restype = _I
    lib.flash_decode_f32.argtypes = [_P] * 7 + [_I] * 7 + [_F, _I, _P]
    lib.flash_attention_fwd_f32.argtypes = [_P] * 5 + [_I] * 6 + [_F] + \
        [_I] * 4 + [_P]
    lib.flash_attention_bwd_f32.argtypes = [_P] * 10 + [_I] * 6 + [_F] + \
        [_I] * 4 + [_P]
    lib.flash_attention_bwd_scratch_floats.argtypes = [_I] * 4
    lib.flash_attention_bwd_scratch_floats.restype = _L
    lib.adamw_update_f32.argtypes = [_P] * 4 + [_L] + [_F] * 8 + [_P]
    lib.sync_flat_update_f32.argtypes = [_P] * 4 + [_L, _I, _F, _P]
    lib.sync_apply_update_f32.argtypes = [_P] * 6 + [_L, _F, _P]
    lib.sync_flat_update_bf16.argtypes = [_P] * 4 + [_L, _I, _F, _P]
    lib.sync_apply_update_bf16.argtypes = [_P] * 6 + [_L, _F, _P]
    lib.ring_combine_f32.argtypes = [_P] * 5 + [_L, _I, _P]
    lib.ring_quantize_f32.argtypes = [_P] * 3 + [_L, _P]
    lib.flash_decode_scratch_floats.argtypes = [_I] * 4
    lib.flash_decode_scratch_floats.restype = _L
    lib.flash_decode_split_range.argtypes = [_I] * 7 + \
        [ctypes.POINTER(_I)] * 2
    lib.flash_decode_next_tile.argtypes = [_I] * 9
    lib.empty_launch.argtypes = [_P]
    lib.cuda_error_string.argtypes = [_I]
    lib.cuda_error_string.restype = ctypes.c_char_p
    for fn in (lib.rmsnorm_f32, lib.rmsnorm_bwd_f32, lib.rmsnorm_bwd_grid,
               lib.swiglu_f32,
               lib.swiglu_fwd_pair_f32, lib.swiglu_bwd_f32,
               lib.flash_decode_f32,
               lib.flash_attention_fwd_f32, lib.flash_attention_bwd_f32,
               lib.adamw_update_f32, lib.sync_flat_update_f32,
               lib.sync_apply_update_f32, lib.sync_flat_update_bf16,
               lib.sync_apply_update_bf16, lib.ring_combine_f32,
               lib.ring_quantize_f32, lib.flash_decode_split_range,
               lib.flash_decode_next_tile, lib.empty_launch):
        fn.restype = _I


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")


def stream_of(t) -> int:
    """PyTorch's current stream on `t`'s device, as a pointer-sized int."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require(name: str, t, *, device, dtype, shape=None, aligned=False) -> None:
    """Raise ShapeError unless `t` is a contiguous tensor of `dtype` on
    `device` (and of `shape`, and 16-byte aligned for float4 loads)."""
    import torch

    from repro_torch.errors import ShapeError
    if not isinstance(t, torch.Tensor):
        raise ShapeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ShapeError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ShapeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ShapeError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ShapeError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ShapeError(f"{name} must be 16-byte aligned for float4 loads")


def require_cuda(name: str, t) -> None:
    from repro_torch.errors import ShapeError
    if not t.is_cuda:
        raise ShapeError(f"{name} is a CUDA kernel; got a tensor on "
                         f"{t.device} (CPU tensors take the plain version "
                         "through kernels/ops.py)")

"""SpMV push: the hand-written Hopper kernel and its plain PyTorch version.

:func:`spmv_push` computes, over a destination-sorted edge stream read as a
CSR matrix (``row_offsets`` into ``src``/``w``),

    out[v] = Σ_{e ∈ [ro[v], ro[v+1])} keep(e) · values[src[e]] · w[e]

with ``keep(e) = mask[e]`` when a mask is given.  It replaces the Pallas
kernel ``repro/kernels/spmv/kernel.py::spmv_push``; the CUDA source
(``csrc/spmv_push.cu``) says how and what bounds it.

On a CUDA tensor the wrapper launches the kernel or raises; only a tensor
that lies on the CPU takes :func:`spmv_push_plain`.  The kernel is compiled
by ``nvcc`` for ``sm_90a`` at first use, into ``build/`` beside this file,
keyed by a hash of the source and flags, and loaded with ``ctypes``.
Nothing is compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "spmv_push.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (looked on PATH and under "
                           "$CUDA_HOME, default /usr/local/cuda)")
    return str(path)


def build_library() -> Path:
    """Compile ``csrc/spmv_push.cu`` into a shared library unless a build of
    this exact source and flag set exists; returns its path.  The compiler's
    output (``-Xptxas -v``: registers, spills) is kept beside it as
    ``.log``."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libspmv_push_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The library's entry point, built and loaded once per process."""
    fn = ctypes.CDLL(str(build_library())).spmv_push_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(values, src, w, row_offsets, mask) -> None:
    dev = values.device
    named = [("values", values, (torch.float32,)), ("src", src, (torch.int32,)),
             ("w", w, (torch.float32,)),
             ("row_offsets", row_offsets, (torch.int32,))]
    if mask is not None:
        named.append(("mask", mask, (torch.bool, torch.uint8)))
    for name, t, dtypes in named:
        if t.device != dev:
            raise ValueError(f"spmv_push: {name} is on {t.device}, values on "
                             f"{dev}")
        if t.dtype not in dtypes:
            raise ValueError(f"spmv_push: {name} must be {dtypes}; got "
                             f"{t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"spmv_push: {name} must be 1-D and contiguous; "
                             f"got shape {tuple(t.shape)}")
    if w.shape != src.shape or (mask is not None and mask.shape != src.shape):
        raise ValueError("spmv_push: w and mask must align with src")
    if row_offsets.shape[0] < 1:
        raise ValueError("spmv_push: row_offsets needs num_rows + 1 entries")
    if max(src.shape[0], values.shape[0], row_offsets.shape[0]) >= 2**31:
        raise ValueError("spmv_push: sizes must fit in int32")


def spmv_push(values: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
              row_offsets: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32[N] = Σ over each row's edge range of ``values[src]·w`` (masked).

    ``values`` f32[N_src], ``src`` i32[E], ``w`` f32[E], ``row_offsets``
    i32[N+1] (non-decreasing, ``row_offsets[N] <= E``), ``mask`` bool or
    u8[E].  CUDA tensors launch the kernel on the current stream (counted in
    ``spmv_push.launches``); CPU tensors take :func:`spmv_push_plain`.
    """
    if values.device.type == "cpu":
        return spmv_push_plain(values, src, w, row_offsets, mask)
    if values.device.type != "cuda":
        raise ValueError(f"spmv_push: unsupported device {values.device}")
    _check(values, src, w, row_offsets, mask)
    num_rows = row_offsets.shape[0] - 1
    out = torch.empty(num_rows, dtype=torch.float32, device=values.device)
    if num_rows == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(values.data_ptr(), src.data_ptr(), w.data_ptr(),
                 row_offsets.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 out.data_ptr(), num_rows, stream)
    if err:
        raise RuntimeError(f"spmv_push: kernel launch failed with CUDA "
                           f"error {err}")
    spmv_push.launches += 1
    return out


#: kernel launches since the last reset (a plain integer)
spmv_push.launches = 0


def spmv_push_plain(values: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
                    row_offsets: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, *,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain PyTorch version of :func:`spmv_push`: an ``index_add_``
    over ``values[src]·w`` in edge order, computed in ``dtype``.  In f32 it
    repeats the JAX package's sequential segment sum; ``torch.float64``
    makes it the oracle the kernel is held against (a sequential f32 sum
    over a 240k-edge hub row drifts ~1e-4 relative from it)."""
    num_rows = row_offsets.shape[0] - 1
    lo, hi = int(row_offsets[0]), int(row_offsets[-1])
    rows = torch.repeat_interleave(
        torch.arange(num_rows, device=values.device),
        (row_offsets[1:] - row_offsets[:-1]).long(), output_size=hi - lo)
    contrib = values.to(dtype)[src[lo:hi].long()] * w[lo:hi].to(dtype)
    if mask is not None:
        contrib = torch.where(mask[lo:hi].bool(), contrib, 0.0)
    out = torch.zeros(num_rows, dtype=dtype, device=values.device)
    return out.index_add_(0, rows, contrib)

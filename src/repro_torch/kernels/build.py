"""How every hand-written kernel of the port is built and loaded.

Each ``csrc/*.cu`` of a kernel family is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``build/`` beside the family's ``kernel.py`` (the parent of its
``csrc/``).  A build is keyed by a hash of its source, the local headers it
includes (``#include "..."``) and the flags, its ``-D`` defines included
(one library per define set, e.g. per merge-path tile of the SpMV
sources), so an edited source builds anew and an unchanged one is loaded
as it is.  The
compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
kept beside the library as ``.log``.  Libraries are loaded with ``ctypes``;
nothing here runs when a module is imported.

Every compile and every load ticks :data:`EVENTS` (as does each tuning
search and timing of :mod:`repro_torch.kernels.spmv.autotune`), so that
:class:`repro_torch.analysis.rebuild.RebuildMonitor` can show a warm loop
adds none.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


#: compiles, loads and tuning runs of this process, by ``kind:name``
EVENTS: collections.Counter = collections.Counter()


def record_event(kind: str, name: str) -> None:
    """Tick the count of one build-side event (``kind`` is ``build``,
    ``load``, ``autotune-search`` or ``autotune-timing``)."""
    EVENTS[f"{kind}:{name}"] += 1


def _label(source: Path, defines: tuple) -> str:
    """``spmv_push.cu[MERGE_ITEMS=7]``: a source and its defines."""
    return source.name + (f"[{','.join(defines)}]" if defines else "")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (looked on PATH and under "
                           "$CUDA_HOME, default /usr/local/cuda)")
    return str(path)


def _key_bytes(source: Path) -> bytes:
    """The source's bytes followed by those of each local header it
    includes, in the order of the includes."""
    text = source.read_bytes()
    headers = re.findall(rb'^\s*#include\s+"([^"]+)"', text, re.MULTILINE)
    return text + b"".join((source.parent / h.decode()).read_bytes()
                           for h in headers)


def build_library(source: Path, defines: tuple = ()) -> Path:
    """Compile one ``csrc/*.cu`` into a shared library unless a build of
    this exact source, its headers and the flag set exists; returns its
    path.  ``defines`` are extra preprocessor defines (``"NAME=value"``
    strings, passed as ``-D``)."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    key = hashlib.sha256(_key_bytes(source)
                         + " ".join(flags).encode()).hexdigest()[:16]
    out_dir = source.resolve().parent.parent / "build"  # <family>/build
    lib = out_dir / f"lib{source.stem}_{key}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    record_event("build", _label(source, defines))
    tmp = out_dir / f"{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source.name} with exit code "
                           f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def current_stream(dev) -> int:
    """The raw pointer of ``dev``'s current CUDA stream, the last argument
    of every entry.  It is what the public
    ``torch.cuda.current_stream(dev).cuda_stream`` gives, read without
    building a ``Stream`` object, which costs several µs of a launch's host
    time."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


@functools.lru_cache(maxsize=None)
def load_entry(source: Path, entry: str, argtypes: tuple,
               defines: tuple = ()):
    """One ``extern "C"`` entry of the library of ``source`` built with
    ``defines``, built and loaded once per process; it returns a CUDA error
    code (``int``, 0 on success)."""
    fn = getattr(ctypes.CDLL(str(build_library(source, defines))), entry)
    record_event("load", f"{_label(source, defines)}:{entry}")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn

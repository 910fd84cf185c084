"""Test-suite bootstrap: make the optional ``hypothesis`` dependency soft.

Six tier-1 modules import hypothesis at module scope; without this shim the
whole suite dies at collection on machines that only have the core
requirements.  The real package wins when installed."""

import importlib.util
import pathlib
import sys

try:
    import hypothesis  # noqa: F401  (real package present — use it)
except ImportError:
    _shim_path = pathlib.Path(__file__).parent / "_hypothesis_compat.py"
    _spec = importlib.util.spec_from_file_location(
        "_hypothesis_compat", _shim_path)
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
    _mod.install()


# Very long single-process runs (the suite is 380+ tests, most of which
# jit-compile fresh programs) can crash XLA's CPU JIT once the live
# executable count grows past a few thousand — a segfault inside
# backend_compile near the end of the run, with every module passing in
# isolation.  Dropping JAX's compilation caches between modules keeps the
# resident executable set bounded without changing any test semantics
# (each module recompiles what it needs).
import jax
import pytest

# Strict dtype promotion for the whole suite: implicit cross-kind
# promotions (f32 + python int is fine; f32 + i32 array is not) raise
# instead of silently widening.  The hot path is f32/bf16-accumulate by
# contract — the jaxpr lint (JXP-F64/JXP-WIDEN64) catches wide dtypes
# structurally, and strict promotion catches the habits that create them
# at the source level.  See docs/analysis.md.
jax.config.update("jax_numpy_dtype_promotion", "strict")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips where there is none)")

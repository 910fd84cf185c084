"""The port's two examples and its ``repro_torch.core`` names against the
JAX package's.

``examples/streaming_pagerank_torch.py::run`` is the paper's protocol on
the port; on the CPU it is held to ``examples/streaming_pagerank.py::run``
at the same arguments: per query the summary's vertex and edge ratios and
the fallback flag equal, RBO within :data:`RBO_ATOL` (measured: equal to
the last bit on synth-citation's three queries); the speedup is a timing
and is not compared.  Neither ported example imports the JAX package or
JAX (``chip_smoke.py``'s ``examples`` phase runs both on the card).  ``repro_torch.core`` exports the names of ``repro.core`` but
``resolve_backend`` (the port has no backend names: a push picks its
kernel by its tensors' device).
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
PORTED = ("quickstart_torch.py", "streaming_pagerank_torch.py")
#: RBO of the port's approximate answer against its exact one, beside the
#: reference's
RBO_ATOL = 1e-6
#: what the port's core leaves out of the reference's, and why
NOT_PORTED = {"resolve_backend": "the port picks the kernel by device"}


@pytest.fixture(scope="module")
def examples():
    sys.path.insert(0, str(EXAMPLES))
    try:
        import streaming_pagerank
        import streaming_pagerank_torch
        yield streaming_pagerank, streaming_pagerank_torch
    finally:
        sys.path.remove(str(EXAMPLES))


def test_streaming_pagerank_matches_the_reference_example(examples):
    ref, port = examples
    kw = dict(dataset="synth-citation", queries=3, verbose=False)
    want = ref.run(**kw)
    got = port.run(device="cpu", **kw)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a["q"] == b["q"]
        for k in ("vertex_ratio", "edge_ratio", "fallback"):
            assert a[k] == b[k], (a["q"], k)
        assert abs(a["rbo"] - b["rbo"]) <= RBO_ATOL
        assert a["speedup"] > 0
    assert got[0]["vertex_ratio"] > 0


@pytest.mark.parametrize("name", PORTED)
def test_ported_examples_import_neither_jax_nor_the_reference(name):
    tree = ast.parse((EXAMPLES / name).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("repro", "jax", "jaxlib"), (name, mod)
    # and at run time: importing it loads neither
    probe = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, "
             f"{str(EXAMPLES)!r}]; import {name[:-3]}; "
             f"bad = [m for m in sys.modules if m.split('.')[0] in "
             f"('repro', 'jax')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", probe], check=True, cwd=ROOT)


def test_core_exports_the_reference_names():
    import importlib

    import repro_torch.core as C

    # each name of repro.core's imports, from the port's module of the
    # same path
    tree = ast.parse((ROOT / "src/repro/core/__init__.py").read_text())
    want = {a.name: node.module.replace("repro.", "repro_torch.", 1)
            for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names}
    assert len(want) == 41 and set(NOT_PORTED) <= set(want)
    for name, module in sorted(want.items()):
        if name in NOT_PORTED:
            assert not hasattr(C, name)
        else:
            assert getattr(C, name) is getattr(
                importlib.import_module(module), name), name


def test_core_imports_without_a_kernel_toolchain():
    # no triton, no nvcc: the import builds and loads nothing
    probe = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); "
             f"import repro_torch.core; "
             f"from repro_torch.kernels.build import EVENTS; "
             f"assert not EVENTS, EVENTS; "
             f"assert 'triton' not in sys.modules and 'jax' not in "
             f"sys.modules")
    subprocess.run([sys.executable, "-c", probe], check=True, cwd=ROOT)

"""Every mutant of ``tools/attention_mutants.py`` still finds its target.

The tool plants each fault by replacing one text of a CUDA source, and
refuses a copy where that text is not found exactly once.  This test holds
every target to that on the CPU, so that an edit of a kernel cannot
silently disarm a mutant before the tool next runs on the card.
"""

import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
_SPEC = importlib.util.spec_from_file_location(
    "attention_mutants", REPO / "tools" / "attention_mutants.py")
MUTANTS = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(MUTANTS)


@pytest.mark.parametrize(
    "name", sorted(n for n, m in MUTANTS.MUTANTS.items() if m is not None))
def test_mutant_target_occurs_once_in_its_source(name):
    mutant = MUTANTS.MUTANTS[name]
    text = (REPO / mutant.path).read_text()
    assert text.count(mutant.text) == 1, (name, mutant.path)
    assert mutant.replacement != mutant.text
    assert mutant.checks in ("forward", "backward")


def test_the_unchanged_copy_is_among_the_mutants():
    assert MUTANTS.MUTANTS["none"] is None

"""The wrong kernels of ``shapegan_tpu_torch.kernel_mutants`` against the
shipped CUDA sources, on the CPU (no nvcc needed): each mutant's source text
occurs exactly once in its file, so an edit of a source cannot quietly turn
a mutant into the sound kernel (text no longer found) or into a different
wrong kernel (text found twice)."""

import os

import pytest

from shapegan_tpu_torch import kernel_mutants as M
from shapegan_tpu_torch.ops import _build


@pytest.mark.parametrize("what, name, old, new", M.ALL_MUTANTS, ids=[m[0] for m in M.ALL_MUTANTS])
def test_mutant_text_occurs_once(what, name, old, new):
    assert name in _build.SOURCES + _build.HEADERS, name
    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        text = f.read()
    assert text.count(old) == 1, (what, name, text.count(old))
    assert new != old, (what, name)

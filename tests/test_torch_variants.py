"""The design variants of ``shapegan_tpu_torch.kernel_variants`` against the
shipped CUDA sources, on the CPU (no nvcc needed): each variant's edits name
source text that is in its file, so that an edit of a source cannot leave a
variant that no longer builds (``built_with`` raises on text it cannot
find) until it is run on the card."""

import os

import pytest

from shapegan_tpu_torch import kernel_variants as V
from shapegan_tpu_torch.ops import _build

EDITS = [(group, what, name, old)
         for group, variants in sorted(vars(V).items()) if group.endswith("VARIANTS")
         for what, edits, *_ in variants for name, old, _new in edits]


@pytest.mark.parametrize("group, what, name, old", EDITS, ids=[f"{e[0]}: {e[1]}" for e in EDITS])
def test_variant_text_is_in_its_source(group, what, name, old):
    assert name in _build.SOURCES + _build.HEADERS, name
    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        assert old in f.read(), (group, what, name)

"""Each C entry point's ctypes signature against its definition.

``kernels/_build.py`` declares, for every ``extern "C"`` function of the
CUDA sources, the argument types that ``ctypes`` passes.  A mismatch does
not fail to compile or to load: it shows only on the card, as a pointer cut
to 32 bits or an int read as an address.  So the declared argument count
and the order of pointers and ints are checked here against the source
text, on the CPU.
"""

import ctypes
import re

import pytest

from repro_torch.kernels import _build

ENTRY_POINTS = [(src, fn) for src, fns in _build.SIGNATURES.items()
                for fn in fns]


def _extern_c_params(src: str) -> dict[str, list[str]]:
    """``{name: [parameter declarations]}`` of the ``extern "C"`` block of
    ``csrc/<src>.cu``."""
    text = (_build.CSRC_DIR / f"{src}.cu").read_text()
    block = text[text.index('extern "C" {'):]
    return {m.group(1): [p.strip() for p in m.group(2).split(",")]
            for m in re.finditer(r"\bint\s+(\w+)\s*\(([^)]*)\)\s*\{", block)}


def _kind(decl: str):
    if "*" in decl:
        return ctypes.c_void_p
    assert re.fullmatch(r"(const\s+)?int\s+\w+", decl), decl
    return ctypes.c_int


@pytest.mark.parametrize("src,fn", ENTRY_POINTS)
def test_signature_matches_the_source(src, fn):
    params = _extern_c_params(src)
    assert fn in params, f"{fn} is not an extern \"C\" function of {src}.cu"
    assert tuple(_kind(p) for p in params[fn]) == _build.SIGNATURES[src][fn]
    assert params[fn][-1].replace(" ", "") == "void*stream"


@pytest.mark.parametrize("src", sorted(_build.SIGNATURES))
def test_every_entry_point_is_declared(src):
    assert sorted(_extern_c_params(src)) == sorted(_build.SIGNATURES[src])

"""The kernel build list against the CUDA sources, on the CPU.

The kernels are compiled only on a machine with a card, so a source
left out of ``_build.SOURCES`` or a ``launch_*`` declared in
``kernels.h`` without its body would first fail there. These checks
read the files and need no compiler.
"""

from __future__ import annotations

import pathlib
import re

import pytest

from p2pfl_tpu_torch.ops import _build, gemm

CSRC = pathlib.Path(_build.__file__).resolve().parent / "csrc"
_DECL = re.compile(r"^void (launch_\w+)\(", re.M)
_INCLUDE = re.compile(r'^#include "([^"]+)"', re.M)
_ENUM = re.compile(r"^enum (\w+) \{([^}]*)\}", re.M)


def _launches_declared() -> list[str]:
    return _DECL.findall((CSRC / "kernels.h").read_text())


def _defined_in(name: str) -> list[str]:
    """The .cu files holding a top-level definition (with a body) of
    ``name``."""
    pat = re.compile(rf"^void {name}\([^;{{]*\)\s*{{", re.M)
    return sorted(p.name for p in CSRC.glob("*.cu")
                  if pat.search(p.read_text()))


@pytest.mark.parametrize("name", sorted(p.name for p in CSRC.glob("*.cu")))
def test_every_cuda_source_is_built(name):
    assert name in _build.SOURCES


@pytest.mark.parametrize("name", sorted(p.name for p in CSRC.glob("*.cuh")))
def test_every_header_is_included_by_a_built_source(name):
    includers = [s for s in _build.SOURCES
                 if name in _INCLUDE.findall((CSRC / s).read_text())]
    assert includers, f"{name} is included by no source of the build"


@pytest.mark.parametrize("name", _build.SOURCES)
def test_every_listed_source_exists(name):
    assert (CSRC / name).is_file()


def test_kernels_h_declares_launches():
    # the parse below found the declarations it checks
    assert len(_launches_declared()) >= 6


@pytest.mark.parametrize("name", _launches_declared())
def test_every_launch_is_defined_in_exactly_one_source(name):
    assert len(_defined_in(name)) == 1, (name, _defined_in(name))


@pytest.mark.parametrize("name", _launches_declared())
def test_every_launch_is_called_by_the_binding(name):
    assert f"p2pfl::{name}(" in (CSRC / "binding.cpp").read_text()


# The codes the binding takes or returns are indices into tuples of names
# on the Python side: kernels.h's enums must list the same names, in the
# same order, numbered from 0.
@pytest.mark.parametrize("enum,names", [
    ("WgradRoute", gemm.WGRAD_ROUTES),
    ("GemmBranch", gemm.STREAM_GEMM_BRANCHES)])
def test_binding_codes_follow_the_python_names(enum, names):
    body = dict(_ENUM.findall((CSRC / "kernels.h").read_text()))[enum]
    entries = re.findall(r"k(?:Wgrad|Gemm)(\w+) = (\d+)", body)
    assert [int(v) for _, v in entries] == list(range(len(names)))
    assert [e.lower() for e, _ in entries] == [
        name.replace("_", "") for name in names]

"""Build-on-first-use loader of the port's CUDA kernels.

``kernels()`` compiles ``ops/csrc/*.cu`` and the PyTorch binding with
``torch.utils.cpp_extension.load`` for ``sm_90a`` into ``ops/_build/``
(git-ignored) the first time a kernel is launched in a process, and
returns the loaded module. Nothing is compiled when the package is
imported, so the CPU-only tests import every module without ``nvcc``.

``SOURCES`` are the translation units handed to the build; the
``csrc/*.cuh`` headers they include are not listed (``load`` would hand
a ``.cuh`` to ``nvcc`` as a translation unit of its own; ninja tracks
them through the compiler's dependency files).
"""

from __future__ import annotations

import functools
import pathlib

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_BUILD = pathlib.Path(__file__).resolve().parent / "_build"

SOURCES = ("binding.cpp", "stream_gemm.cu", "stream_wgrad.cu",
           "dense_bwd.cu", "gemm_f32_tc.cu", "sgd.cu",
           "sgd_accum.cu", "fused_train.cu")


@functools.cache
def kernels():
    """Compile (or reuse) and load the extension; raises if it fails."""
    import torch
    from torch.utils.cpp_extension import load

    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    _BUILD.mkdir(parents=True, exist_ok=True)
    return load(
        name="p2pfl_tpu_torch_kernels",
        sources=[str(_CSRC / s) for s in SOURCES],
        build_directory=str(_BUILD),
        extra_cflags=["-O3"],
        extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"],
        extra_include_paths=[str(_CSRC)],
        verbose=False,
    )

"""Textual variants of a kernel source, built for the ablation scripts.

``build_variants(source, variants, signatures)`` writes one copy of
``src/repro_torch/kernels/csrc/<source>.cu`` per variant, each with its
``(old, new)`` replacements made (a replacement that no longer applies to
the source fails the run, naming the text it looked for), compiles them
like the kernel (``nvcc`` for sm_90a, all at once) into the kernels' build
directory and loads each with ``ctypes``.  ``build_sources`` does the same
for given source files (another tree's kernel, say).
"""
from __future__ import annotations

import ctypes
import subprocess

from repro_torch.kernels import _build


def build_variants(source: str, variants: dict, signatures: dict) -> dict:
    """``variants`` maps a name to its list of ``(old, new)`` replacements,
    ``signatures`` each exported function to its ``argtypes`` (every one
    returns a ``cudaError_t`` as an int).  Returns ``{name: ctypes.CDLL}``.
    """
    src = (_build.CSRC / f"{source}.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    files = {}
    for i, (name, subs) in enumerate(variants.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: the source no longer "
                                   f"holds {old.strip()[:60]!r}")
            text = text.replace(old, new)
        cu = _build.BUILD_DIR / f"{source}_ablation_{i}.cu"
        cu.write_text(text)
        files[name] = (cu, signatures)
    return build_sources(files)


def build_sources(files: dict) -> dict:
    """``files`` maps a name to ``(path of a .cu file, signatures)``; each
    is compiled like the kernels, all at once, next to its source when that
    lies in the kernels' build directory and into it otherwise.  Returns
    ``{name: ctypes.CDLL}``."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (cu, _)) in enumerate(files.items()):
        so = (cu.with_suffix(".so") if cu.parent == _build.BUILD_DIR
              else _build.BUILD_DIR / f"{cu.stem}_build_{i}.so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in files[name][1].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs

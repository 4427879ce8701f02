"""Build the CUDA sources of ``kernels/csrc`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The
libraries land in ``kernels/build/`` (git-ignored) under a name that hashes
the source and the flags, so an edited source rebuilds and an unchanged one
loads at once.  ``build_all`` starts one ``nvcc`` per source, all at the
same time.  Nothing here runs when the package is imported: a machine
without ``nvcc`` imports every module and only fails when a CUDA tensor
reaches a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("quant_transfer", "topk_compress", "flash_attention", "ssd_scan")
# no --use_fast_math: the quantizer needs IEEE division, flash attention
# and the SSD scan the accurate expf (and tanhf)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def build_all(names: Iterable[str] = SOURCES,
              verbose: bool = False) -> Dict[str, str]:
    """Compile every listed source that is not built yet, one ``nvcc`` each,
    all started together.  Returns ``{name: compiler output}`` for what was
    compiled; ``verbose`` adds ``-Xptxas=-v`` (registers, shared memory and
    spills per kernel; the binary is the same).  Raises with the compiler's
    output if any build fails."""
    extra = ("-Xptxas=-v",) if verbose else ()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str, signatures: Optional[Dict[str, tuple]] = None
         ) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built if needed).
    ``signatures`` maps each exported function to its ``argtypes``; every
    function returns a ``cudaError_t`` as an int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in (signatures or {}).items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def wants_kernel(t, what: str) -> bool:
    """Dispatch on the tensor's device: True for CUDA (launch the kernel),
    False for CPU (the plain version) and for ``meta`` (the plain version
    propagates shapes and dtypes, allocating and launching nothing: the
    dry runs' abstract evaluation); anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{what}: no kernel for device {t.device}")


def check_launch(err: int, what: str) -> None:
    """Raise on the ``cudaError_t`` a launch returned."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")

"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``build/ra_tpu_torch/<name>-<hash>.so`` under the checkout
root.  The hash covers the sources and the compiler flags, so a stale
library is never loaded and an unchanged one is never rebuilt.  Nothing
here runs at import time: the first call that needs a kernel builds it.
``nvcc`` missing or failing raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ra_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_FNS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build ra_tpu_torch's kernels")
    return path


def sources() -> list:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Build every named source not yet built (default: all of them), one
    ``nvcc`` per source, all started together.  Returns
    ``{name: compiler output}`` for the sources compiled by this call."""
    names = sources() if names is None else list(names)
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, target in todo:
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for name, target, tmp, proc in procs:
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def kernel(name: str, entry: str, argtypes: list, args=None):
    """``entry`` of csrc/<name>.cu as a ctypes function returning its int
    (a CUDA error code) and taking ``argtypes``, cached.  With ``args``,
    the ctypes Structure the entry takes a pointer to, the source's
    ``<entry>_args_size`` must report that Structure's size."""
    fn = _FNS.get(entry)
    if fn is None:
        lib = load(name)
        if args is not None:
            size = getattr(lib, f"{entry}_args_size")
            size.argtypes, size.restype = [], ctypes.c_int
            if size() != ctypes.sizeof(args):
                raise RuntimeError(
                    f"csrc/{name}.cu takes {size()} bytes of arguments, "
                    f"the wrapper passes {ctypes.sizeof(args)}")
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FNS[entry] = fn
    return fn

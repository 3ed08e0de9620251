"""Build the port's CUDA kernels on first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``
process (all started together), then the objects are linked into one
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

The library lands in ``build/repro_torch/<hash>/`` at the root of the
checkout, keyed by a hash of the sources and flags, so an unchanged tree
builds once; the compilers' ``-Xptxas -v`` output lies beside it in
``ptxas.txt``. No source includes PyTorch's headers: a build takes seconds,
where ``torch.utils.cpp_extension.load`` takes minutes.

Callers launch on ``torch.cuda.current_stream().cuda_stream``; every C
entry returns ``cudaGetLastError()`` and :func:`check` raises on non-zero.

A wrapper also takes ``meta`` tensors (:data:`DEVICES`): it then allocates
exactly what its launch allocates, its outputs and scratch, and stops
before the launch (:func:`shape_only`), so that ``core.trace`` sees the
kernel's own footprint. A ``meta`` tensor computes nothing anywhere.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import List, Tuple

import torch

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the "
            "port's CUDA kernels are built on the machine with the card")
    return str(path)


def compile_commands(out_dir: pathlib.Path) -> Tuple[List[List[str]],
                                                     List[str]]:
    """The per-source compile commands and the link command."""
    cc = nvcc()
    objs = [out_dir / (p.stem + ".o") for p in sources()]
    compiles = [[cc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(sources(), objs)]
    link = [cc, *NVCC_FLAGS[:6], "-shared", *map(str, objs),
            "-o", str(out_dir / LIB_NAME)]
    return compiles, link


def build() -> Tuple[pathlib.Path, str, float]:
    """Compile (unless this source hash is built) and return the library's
    path, the compiler's output and the seconds the build took."""
    final = BUILD_DIR / source_hash() / LIB_NAME
    if final.exists():
        return final, "", 0.0
    t0 = time.perf_counter()
    work = final.parent / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    compiles, link = compile_commands(work)
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    logs = []
    failed = []
    for cmd, proc in zip(compiles, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    res = subprocess.run(link, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
    (final.parent / "ptxas.txt").write_text("".join(logs))
    os.replace(work / LIB_NAME, final)     # atomic against a parallel build
    shutil.rmtree(work, ignore_errors=True)
    return final, "".join(logs), time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    path, _, _ = build()
    return ctypes.CDLL(str(path))


def entry(name: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry of the kernel library with its argument types declared
    (``c_void_p`` for pointers and the stream, ``c_int`` for ints), so
    ctypes never cuts a pointer to 32 bits."""
    fn = getattr(lib(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


DEVICES = ("cuda", "meta")


def shape_only(t: torch.Tensor) -> bool:
    """True for a ``meta`` tensor: the wrapper has allocated what its launch
    would and launches nothing."""
    return t.device.type == "meta"


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream

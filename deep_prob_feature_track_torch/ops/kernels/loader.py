"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<source>.cu`` exports the plain C launch functions of one or
more kernels (``SOURCES``).  It is compiled
with ``nvcc`` for ``sm_90a`` into its own shared library under ``_build/``
(listed in ``.gitignore``) and bound with ``ctypes``: no PyTorch headers,
so a build takes seconds.  The build runs at first use, never at import,
so the package imports on a machine without ``nvcc``; a file lock guards it
against concurrent processes, and a library is reused only when its file
name's hash of source and flags matches.

Each launch function takes one argument, a pointer to its arguments packed
in a C struct: :func:`launcher` packs them with ``struct`` in the native
layout, which is the struct's, and passes the bytes.  One ``ctypes``
argument converts in a fraction of the time that a dozen take, and the
wrappers' host path is what a small launch costs.  :func:`launcher` adds one
to ``LAUNCHES[name]`` where it launches the kernel, so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
# kernel name -> the csrc/ source that holds it
SOURCES = {
    "gather_twohot": "gather_twohot",
    "gather_twohot_grads": "gather_twohot",
    "splat_twohot": "splat_twohot",
    "fused_jtj_jtr": "fused_jtj_jtr",
    "gather_tiles": "gather_tiles",
    "gather_tiles_grads": "gather_tiles",
}
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
# C launch function -> the struct format its one argument is packed with
FORMATS: Dict[str, str] = {}

_libs: Dict[str, ctypes.PyDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(source: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{source}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source}_{digest}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile the source of every kernel in ``names`` whose library is
    missing, one ``nvcc`` process per source, all started together.  Returns
    each source's library; raises with the compiler's output when a build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {s: _target(s) for s in sorted({SOURCES[n] for n in names})}
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            procs = {}
            for source, target in targets.items():
                if target.exists():
                    continue
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{source}.cu")]
                procs[source] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            errors = []
            for source, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                (BUILD_DIR / f"{source}.log").write_text(out)
                if proc.returncode != 0:
                    errors.append(f"{source}: nvcc exited {proc.returncode}\n{out}")
                else:
                    os.replace(tmp, targets[source])
            if errors:
                raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return targets


def _library(name: str) -> ctypes.PyDLL:
    """Kernel ``name``'s library, built and loaded at first use.  Loaded as a
    ``PyDLL``: its launch functions never call back into Python, so a call
    keeps the GIL rather than paying to drop and take it again."""
    with _lock:
        source = SOURCES[name]
        if source not in _libs:
            _libs[source] = ctypes.PyDLL(str(build([name])[source]))
        return _libs[source]


def launcher(name: str, symbol: str, fmt: str) -> Callable[..., None]:
    """A function that launches kernel ``name`` through its C launch function
    ``symbol``: it packs its arguments by the ``struct`` format ``fmt`` (the C
    struct's fields in order), passes a pointer to them, raises if the launch
    returned a CUDA error, and adds one to ``LAUNCHES[name]``.  The library is
    built and bound at the first launch."""
    pack = struct.Struct(fmt).pack
    FORMATS[symbol] = fmt
    fn = None

    def launch(*args) -> None:
        nonlocal fn
        if fn is None:
            fn = getattr(_library(name), symbol)  # returns int; bytes pass as char*
        status = fn(pack(*args))
        if status:
            raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")
        LAUNCHES[name] += 1

    return launch


def raw_stream(device_index: int) -> int:
    """The handle of PyTorch's current stream on CUDA device
    ``device_index``, without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device_index)

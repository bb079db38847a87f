"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C launch function.  It is compiled
with ``nvcc`` for ``sm_90a`` into its own shared library under ``_build/``
(listed in ``.gitignore``) and bound with ``ctypes``: no PyTorch headers,
so a build takes seconds.  The build runs at first use, never at import,
so the package imports on a machine without ``nvcc``; a file lock guards it
against concurrent processes, and a library is reused only when its file
name's hash of source and flags matches.

Every wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel,
so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
KERNELS = ("gather_twohot", "gather_twohot_grads", "splat_twohot", "fused_jtj_jtr")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], Callable] = {}
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


def _target(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every kernel in ``names`` whose library is missing, one
    ``nvcc`` process per source, all started together.  Raises with the
    compiler's output when a build fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            procs = {}
            for name, target in targets.items():
                if target.exists():
                    continue
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                procs[name] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            errors = []
            for name, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                (BUILD_DIR / f"{name}.log").write_text(out)
                if proc.returncode != 0:
                    errors.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
                else:
                    os.replace(tmp, targets[name])
            if errors:
                raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return targets


def function(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int) -> Callable:
    """C function ``symbol`` of kernel ``name``'s library with its signature
    set (every pointer as ``c_void_p``, so ctypes never truncates one),
    building and loading the library at first use."""
    fn = _fns.get((name, symbol))
    if fn is not None:
        return fn
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build([name])[name]))
        fn = getattr(_libs[name], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[(name, symbol)] = fn
        return fn


def check(status: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")

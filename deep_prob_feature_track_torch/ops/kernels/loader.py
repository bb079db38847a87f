"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<source>.cu`` exports the plain C launch functions of one or
more kernels (``SOURCES``).  It is compiled
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
# kernel name -> the csrc/ source that holds it
SOURCES = {
    "gather_twohot": "gather_twohot",
    "gather_twohot_grads": "gather_twohot_grads",
    "splat_twohot": "splat_twohot",
    "fused_jtj_jtr": "fused_jtj_jtr",
    "gather_tiles": "gather_tiles",
    "gather_tiles_grads": "gather_tiles",
}
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

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


def function(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int) -> Callable:
    """C function ``symbol`` of kernel ``name``'s library with its signature
    set (every pointer as ``c_void_p``, so ctypes never truncates one),
    building and loading the library at first use."""
    fn = _fns.get((name, symbol))
    if fn is not None:
        return fn
    with _lock:
        source = SOURCES[name]
        if source not in _libs:
            _libs[source] = ctypes.CDLL(str(build([name])[source]))
        fn = getattr(_libs[source], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[(name, symbol)] = fn
        return fn


def check(status: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")

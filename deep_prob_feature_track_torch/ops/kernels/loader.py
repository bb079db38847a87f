"""Build and load the port's hand-written CUDA kernels and host code.

Each ``csrc/<source>.cu`` exports the plain C launch functions of one or
more kernels (``SOURCES``).  It is compiled
with ``nvcc`` for ``sm_90a`` into its own shared library under ``_build/``
(listed in ``.gitignore``) and bound with ``ctypes``: no PyTorch headers,
so a build takes seconds.  The build runs at first use, never at import,
so the package imports on a machine without ``nvcc``; a file lock guards it
against concurrent processes, and a library is reused only when its file
name's hash of source and flags matches.

:func:`build_host` is the host flavour of the same build: a ``.cpp`` source
compiled by the host's C++ compiler (``$CXX``, else ``c++``) with
``HOST_CXX_FLAGS``, which ask for no host-specific instructions and no
contracted floating point, so that its results do not depend on the host.

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
import shlex
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
HOST_CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")
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


def _compile(build_dir: Path, jobs: Dict[str, Tuple[Path, Sequence[str]]], tool: str) -> None:
    """Under ``build_dir``'s file lock, run the compiler command of every
    job ``source -> (library, command)`` whose library is missing, all
    started together, each writing ``-o`` a temporary file that replaces
    the library once it is whole; the output lands in
    ``build_dir/<source>.log``.  Raises with the compiler's output when a
    build fails."""
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            procs = {}
            for source, (target, command) in jobs.items():
                if target.exists():
                    continue
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                procs[source] = (tmp, target, subprocess.Popen(
                    [*command, "-o", str(tmp)], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
            errors = []
            for source, (tmp, target, proc) in procs.items():
                out, _ = proc.communicate()
                (build_dir / f"{source}.log").write_text(out)
                if proc.returncode != 0:
                    errors.append(f"{source}: {tool} exited {proc.returncode}\n{out}")
                else:
                    os.replace(tmp, target)
            if errors:
                raise RuntimeError(f"{tool} build failed:\n" + "\n".join(errors))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile the source of every kernel in ``names`` whose library is
    missing, one ``nvcc`` process per source, all started together.  Returns
    each source's library; raises with the compiler's output when a build
    fails."""
    targets = {s: _target(s) for s in sorted({SOURCES[n] for n in names})}
    if any(not t.exists() for t in targets.values()):
        nvcc = _nvcc()
        _compile(BUILD_DIR, {s: (t, [nvcc, *NVCC_FLAGS, str(CSRC / f"{s}.cu")])
                             for s, t in targets.items()}, "nvcc")
    return targets


def host_cxx() -> List[str]:
    """The host's C++ compiler command: ``$CXX`` (split as a shell would),
    else ``c++``; raises if it is not on the ``PATH``."""
    command = shlex.split(os.environ.get("CXX") or "c++")
    if not command or shutil.which(command[0]) is None:
        raise RuntimeError(f"no host C++ compiler {command[:1]} on the PATH: set $CXX or "
                           "install c++ to build the port's host code")
    return command


def host_target(source: Path, build_dir: Path) -> Path:
    """Where :func:`build_host` puts the library of ``source``: its name
    holds a hash of the source, the compiler command and the flags."""
    command = " ".join([*host_cxx(), *HOST_CXX_FLAGS])
    digest = hashlib.sha256(source.read_bytes() + command.encode()).hexdigest()[:16]
    return build_dir / f"lib{source.stem}_{digest}.so"


def build_host(source: Path, build_dir: Path) -> Path:
    """The shared library of the C++ file ``source``, compiled into
    ``build_dir`` by :func:`host_cxx` with ``HOST_CXX_FLAGS`` unless a
    library of the same source, compiler and flags is there already."""
    target = host_target(source, build_dir)
    if not target.exists():
        command = [*host_cxx(), *HOST_CXX_FLAGS, str(source)]
        _compile(build_dir, {source.stem: (target, command)}, command[0])
    return target


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

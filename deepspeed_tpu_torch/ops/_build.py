"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
``build/lib<name>-<hash>.so`` inside the package (the directory is in
``.gitignore``), where ``<hash>`` is a digest of the source and of every
shared header ``csrc/*.cuh``, so an edited kernel or header never loads a
stale build. The sources have a plain C interface and
include no PyTorch header, which keeps a build to seconds. Nothing here
runs at import time: this module must import on machines without
``nvcc`` or a GPU.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD = os.path.join(os.path.dirname(CSRC), "build")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel names, one per ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "deepspeed_tpu_torch build only where the CUDA "
                           "toolkit is installed")
    return nvcc


def _target(name: str) -> str:
    """The library path of ``csrc/<name>.cu``, keyed by a digest of the
    source and of every header it may include."""
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    digest = hashlib.sha256()
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as src:
            digest.update(src.read())
    return os.path.join(BUILD, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _command(name: str, out: str) -> List[str]:
    return [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
            "-fPIC", "-o", out,
            os.path.join(CSRC, name + ".cu")]


def build(names=None) -> None:
    """Compile the named kernels (default: all) that have no current
    build, one ``nvcc`` process per source, all started together; raises
    ``RuntimeError`` with the compiler output when a build fails."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(_command(name, tmp),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(_target(name))
        return lib


# ---------------------------------------------------------------------------
# host libraries: the SIMD CPU optimizers and the async-IO module
# ---------------------------------------------------------------------------

HOST_CSRC = os.path.join(CSRC, "host")
#: library name -> (sources, headers they include), under ``csrc/host/``
HOST_LIBS = {
    "cpu_adam": (["cpu_adam.cpp"], ["bf16.h"]),
    "cpu_adagrad": (["cpu_adagrad.cpp"], ["bf16.h"]),
    "aio": (["ds_aio.cpp", "ds_aio_uring.cpp"], ["ds_aio_backend.h"]),
}
#: the JAX package's flags (its ``csrc/Makefile``), so both packages' host
#: libraries compute the same bits
HOST_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
              "-pthread", "-Wall"]


def _cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) found: the host "
                           "libraries of deepspeed_tpu_torch (cpu_adam, "
                           "cpu_adagrad, aio) build with one")
    return cxx


def host_lib_path(name: str) -> str:
    return os.path.join(BUILD, f"libds_{name}.so")


def _host_stale(name: str) -> bool:
    """True when the library is missing or older than any of its sources
    or headers (the staleness rule of the JAX package's op builder)."""
    lib = host_lib_path(name)
    if not os.path.exists(lib):
        return True
    srcs, headers = HOST_LIBS[name]
    built = os.path.getmtime(lib)
    return any(os.path.getmtime(os.path.join(HOST_CSRC, f)) > built
               for f in srcs + headers)


def build_host(names=None) -> None:
    """Compile the named host libraries (default: all) that are stale with
    ``g++``, all started together; raises ``RuntimeError`` with the
    compiler output when a build fails or no compiler exists."""
    names = list(HOST_LIBS) if names is None else list(names)
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
        if not _host_stale(name):
            continue
        out = host_lib_path(name)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_cxx(), *HOST_FLAGS, "-o", tmp,
               *(os.path.join(HOST_CSRC, s) for s in HOST_LIBS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("g++ failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library ``name`` (``cpu_adam``, ``cpu_adagrad``,
    ``aio``), built first if needed."""
    key = "host:" + name
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build_host([name])
            lib = _libs[key] = ctypes.CDLL(host_lib_path(name))
        return lib

"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
``build/lib<name>-<hash>.so`` inside the package (the directory is in
``.gitignore``), where ``<hash>`` is a digest of the source, so an edited
kernel never loads a stale build. The sources have a plain C interface and
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
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD, f"lib{name}-{digest}.so")


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

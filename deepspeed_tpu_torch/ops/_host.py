"""Host buffers for the ``ctypes`` host libraries: contiguous CPU tensors
whose data pointers the C++ reads and writes in place."""

import ctypes
from typing import Optional

import numpy as np
import torch


def host_tensor(x, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a contiguous CPU tensor of ``dtype``: the tensor itself
    (or a writable numpy array's memory) when it already is one, else a
    converted copy. The C++ writes through the pointer, so a read-only
    numpy array is copied, never aliased."""
    if isinstance(x, np.ndarray):
        if x.flags.writeable and x.flags.c_contiguous and \
                x.dtype == torch.empty((), dtype=dtype).numpy().dtype:
            return torch.from_numpy(x)
        x = torch.from_numpy(np.array(x))
    t = torch.as_tensor(x)
    if t.device.type == "cpu" and t.dtype == dtype and t.is_contiguous():
        return t
    return t.detach().to(device="cpu", dtype=dtype).contiguous()


def ptr(t: Optional[torch.Tensor], ctype=ctypes.c_float):
    """A ``ctypes`` pointer to a contiguous CPU tensor's data (None for
    None)."""
    if t is None:
        return None
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError("host kernels take contiguous CPU tensors")
    return ctypes.cast(ctypes.c_void_p(t.data_ptr()), ctypes.POINTER(ctype))


def bf16_out_view(t: torch.Tensor, n: int) -> torch.Tensor:
    """A bf16 output buffer of ``n`` elements (a bfloat16, int16 or uint16
    CPU tensor, or a uint16 numpy array) as the tensor the C++ writes."""
    if isinstance(t, np.ndarray):
        assert t.dtype == np.uint16, t.dtype
        t = torch.from_numpy(t.view(np.int16))
    if t.numel() != n or t.element_size() != 2:
        raise ValueError(f"bf16_out needs {n} two-byte elements, got "
                         f"{t.numel()} of {t.dtype}")
    return t


#: the size of one pinned host allocation that ``host_buffers`` packs
#: buffers into (the CUDA caching host allocator rounds every allocation
#: up to a power of two, so one pinned tensor a leaf can cost up to twice
#: its bytes)
PINNED_ARENA_BYTES = 1 << 31


def host_buffers(numels, dtype, pin: bool):
    """One flat CPU buffer of ``dtype`` for each count of ``numels``.
    Pinned (``pin``): packed largest first into shared arenas of at most
    ``PINNED_ARENA_BYTES`` (a buffer larger than that gets its own), each
    buffer 512-byte aligned, so the host pays about the bytes it asked
    for."""
    numels = [int(n) for n in numels]
    if not pin:
        return [torch.empty(n, dtype=dtype) for n in numels]
    esz = torch.empty((), dtype=dtype).element_size()
    out = [None] * len(numels)
    arenas = []         # [used bytes, [(index, offset)]]
    for i in sorted(range(len(numels)), key=lambda i: -numels[i]):
        nbytes = -(-numels[i] * esz // 512) * 512
        if nbytes > PINNED_ARENA_BYTES:
            out[i] = torch.empty(numels[i], dtype=dtype, pin_memory=True)
            continue
        for arena in arenas:
            if arena[0] + nbytes <= PINNED_ARENA_BYTES:
                break
        else:
            arena = [0, []]
            arenas.append(arena)
        arena[1].append((i, arena[0]))
        arena[0] += nbytes
    for used, members in arenas:
        mem = torch.empty(used, dtype=torch.uint8, pin_memory=True)
        for i, off in members:
            out[i] = mem[off:off + numels[i] * esz].view(dtype)
    return out

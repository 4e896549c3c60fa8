"""Async file IO over the native module (``csrc/host/ds_aio.cpp``, the
thread-pool backend, and ``ds_aio_uring.cpp``, the io_uring ring).

Counterpart of ``deepspeed_tpu/ops/aio/handle.py`` (``AsyncIOHandle``,
``aio_handle``, ``uring_available``): the NVMe swap of optimizer moments
and parameters (ZeRO-Infinity). Buffers are contiguous CPU tensors or
numpy arrays; async ops return at once and ``wait()`` fences them. The
file format is the buffer's raw bytes, so either package reads the
other's files.
"""

import ctypes
import time

import numpy as np

from .. import _build

_BACKENDS = {"auto": 0, "pool": 1, "uring": 2}


def _lib():
    lib = _build.load_host("aio")
    lib.ds_aio_handle_create3.restype = ctypes.c_void_p
    lib.ds_aio_pread.restype = ctypes.c_int64
    lib.ds_aio_pwrite.restype = ctypes.c_int64
    lib.ds_aio_wait.restype = ctypes.c_int64
    lib.ds_aio_backend_name.restype = ctypes.c_char_p
    return lib


class AsyncIOHandle:
    def __init__(self, block_size: int = 1 << 20, queue_depth: int = 32,
                 single_submit: bool = False, overlap_events: bool = False,
                 num_threads: int = 1, use_o_direct: bool = False,
                 backend: str = "auto"):
        self._lib = _lib()
        # "uring": queue_depth kernel-async ops in flight off one driver
        # thread; "pool": pread/pwrite workers; "auto" is the pool. With
        # use_o_direct, aligned chunks bypass the page cache through
        # aligned bounce buffers, and a filesystem that refuses O_DIRECT
        # takes buffered IO.
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {sorted(_BACKENDS)}, "
                             f"got {backend!r}")
        self._h = self._lib.ds_aio_handle_create3(
            ctypes.c_int64(block_size), ctypes.c_int(queue_depth),
            ctypes.c_int(int(single_submit)), ctypes.c_int(int(overlap_events)),
            ctypes.c_int(num_threads), ctypes.c_int(int(use_o_direct)),
            ctypes.c_int(_BACKENDS[backend]))
        if not self._h:
            raise OSError(f"aio backend {backend!r} unavailable on this kernel")
        self.backend = self._lib.ds_aio_backend_name(
            ctypes.c_void_p(self._h)).decode()
        self.block_size = block_size
        self.queue_depth = queue_depth
        self.num_threads = num_threads
        self.use_o_direct = use_o_direct
        #: bytes submitted to read and to write, the seconds spent blocked
        #: in ``wait``, and the seconds from each batch's first async
        #: submission to the ``wait`` that fences it (the batch's ops end
        #: inside that span, so bytes over it is a lower bound on the
        #: rate); a synchronous op counts its own call in both
        self.bytes_read = self.bytes_written = 0
        self.wait_s = self.inflight_s = 0.0
        self._since = None

    @staticmethod
    def _buf(buf):
        """(pointer, bytes) of a contiguous CPU tensor or numpy array."""
        if isinstance(buf, np.ndarray):
            assert buf.flags["C_CONTIGUOUS"], "aio buffers must be contiguous"
            return buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("aio buffers must be contiguous CPU tensors")
        return ctypes.c_void_p(buf.data_ptr()), buf.numel() * buf.element_size()

    def _submit(self, fn, buf, path: str, offset: int, async_op: bool,
                what: str) -> int:
        p, nbytes = self._buf(buf)
        t = time.perf_counter()
        if async_op and self._since is None:
            self._since = t
        rc = fn(ctypes.c_void_p(self._h), path.encode(), p,
                ctypes.c_int64(nbytes), ctypes.c_int64(offset),
                ctypes.c_int(int(async_op)))
        if not async_op:
            spent = time.perf_counter() - t
            self.wait_s += spent
            self.inflight_s += spent
        if rc < 0:
            raise OSError(f"aio {what} failed: {path}")
        if what == "read":
            self.bytes_read += nbytes
        else:
            self.bytes_written += nbytes
        return int(rc)

    def pwrite(self, buf, path: str, offset: int = 0,
               async_op: bool = False) -> int:
        return self._submit(self._lib.ds_aio_pwrite, buf, path, offset,
                            async_op, "write")

    def pread(self, buf, path: str, offset: int = 0,
              async_op: bool = False) -> int:
        return self._submit(self._lib.ds_aio_pread, buf, path, offset,
                            async_op, "read")

    sync_pwrite = pwrite
    sync_pread = pread

    def async_pwrite(self, buf, path, offset: int = 0):
        return self.pwrite(buf, path, offset, async_op=True)

    def async_pread(self, buf, path, offset: int = 0):
        return self.pread(buf, path, offset, async_op=True)

    def wait(self) -> int:
        t = time.perf_counter()
        rc = int(self._lib.ds_aio_wait(ctypes.c_void_p(self._h)))
        now = time.perf_counter()
        self.wait_s += now - t
        if self._since is not None:
            self.inflight_s += now - self._since
            self._since = None
        if rc < 0:
            raise OSError("aio op failed during wait")
        return rc

    def close(self):
        if self._h:
            self._lib.ds_aio_handle_destroy(ctypes.c_void_p(self._h))
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def aio_handle(block_size: int = 1 << 20, queue_depth: int = 32,
               single_submit: bool = False, overlap_events: bool = False,
               num_threads: int = 1, use_o_direct: bool = False,
               backend: str = "auto") -> AsyncIOHandle:
    """The reference's factory name (``deepspeed.ops.aio.aio_handle``)."""
    return AsyncIOHandle(block_size, queue_depth, single_submit, overlap_events,
                         num_threads, use_o_direct, backend)


def uring_available() -> bool:
    return bool(_lib().ds_aio_uring_available())


from .handle import AsyncIOHandle, aio_handle, uring_available  # noqa: F401

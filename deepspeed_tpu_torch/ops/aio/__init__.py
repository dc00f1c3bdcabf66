from .aio_handle import AsyncIOHandle, aio_available

__all__ = ["AsyncIOHandle", "aio_available"]

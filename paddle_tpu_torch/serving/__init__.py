from .engine import Engine
from .kv_cache import BlockAllocator, PagedKVCache
from .scheduler import Request, RequestState, Scheduler

__all__ = ["BlockAllocator", "Engine", "PagedKVCache", "Request",
           "RequestState", "Scheduler"]

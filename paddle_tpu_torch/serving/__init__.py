from .engine import AdmissionError, DrainingError, Engine, QueueFullError
from .kv_cache import BlockAllocator, PagedKVCache
from .scheduler import Request, RequestState, Scheduler

__all__ = ["AdmissionError", "BlockAllocator", "DrainingError", "Engine",
           "PagedKVCache", "QueueFullError", "Request", "RequestState",
           "Scheduler"]

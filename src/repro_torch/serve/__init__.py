"""Continuous-batching serving engine of the port."""
from repro_torch.serve.engine import ServeEngine, pack_lm_head
from repro_torch.serve.errors import (OutOfPages, RequestRejected,
                                      ServeError)
from repro_torch.serve.packed import PackedModel, PackEntry, pack_model
from repro_torch.serve.paging import PagedKVCache
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serve.trace import poisson_trace

__all__ = ["OutOfPages", "PackEntry", "PackedModel", "PagedKVCache",
           "Request", "RequestRejected", "RequestState", "ServeEngine",
           "ServeError", "SlotScheduler", "pack_lm_head", "pack_model",
           "poisson_trace"]

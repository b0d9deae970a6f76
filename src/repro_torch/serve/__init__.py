"""Continuous-batching serving engine of the port."""
from repro_torch.serve.engine import ServeEngine, pack_lm_head
from repro_torch.serve.errors import (AuditViolation, DeadlineExceeded,
                                      OutOfPages, RequestRejected,
                                      ServeError, ServeOverloaded)
from repro_torch.serve.faults import Fault, FaultPlan, InvariantAuditor
from repro_torch.serve.packed import PackedModel, PackEntry, pack_model
from repro_torch.serve.paging import PagedKVCache
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serve.telemetry import (ChromeTrace, Clock, Counter,
                                         EventLog, Gauge, Histogram,
                                         MetricsRegistry, StepSpans,
                                         Telemetry, load_trace,
                                         validate_events, validate_trace)
from repro_torch.serve.trace import poisson_trace
from repro_torch.serve.traffic import TrafficLedger, role_of

__all__ = ["AuditViolation", "ChromeTrace", "Clock", "Counter",
           "DeadlineExceeded", "EventLog", "Fault", "FaultPlan", "Gauge",
           "Histogram", "InvariantAuditor", "MetricsRegistry",
           "OutOfPages", "PackEntry", "PackedModel", "PagedKVCache",
           "Request", "RequestRejected", "RequestState", "ServeEngine",
           "ServeError", "ServeOverloaded", "SlotScheduler", "StepSpans",
           "Telemetry", "TrafficLedger", "load_trace", "pack_lm_head",
           "pack_model", "poisson_trace", "role_of", "validate_events",
           "validate_trace"]

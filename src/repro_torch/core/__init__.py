"""BCL Core for the PyTorch port: backends, pointers, promises, costs and
the exchange engine (see ``repro.core`` for the design)."""

from repro_torch.core.backend import Backend, ProcessGroupBackend, SerialBackend
from repro_torch.core.promises import ConProm, Promise
from repro_torch.core.pointers import GlobalPointer
from repro_torch.core.exchange import (ExchangeOverflowError, ExchangePlan,
                                       PendingPlan, PendingResult, RouteResult,
                                       carry_mask, reply, route, suggest_rounds)
from repro_torch.core.transport import (DenseTransport, HierarchicalTransport,
                                        Transport, make_transport)
from repro_torch.core.faults import FaultInjectingTransport, FaultSpec
from repro_torch.core import costs

__all__ = [
    "Backend", "SerialBackend", "ProcessGroupBackend",
    "ConProm", "Promise", "GlobalPointer",
    "ExchangePlan", "ExchangeOverflowError", "PendingPlan", "PendingResult",
    "RouteResult", "carry_mask", "route", "reply", "suggest_rounds",
    "Transport", "DenseTransport", "HierarchicalTransport", "make_transport",
    "FaultSpec", "FaultInjectingTransport",
    "costs",
]

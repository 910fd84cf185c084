"""Multi-tenant graph-query serving (PyTorch port of ``repro.serve``'s graph
engine): slot-batched waves of B queries over one shared graph."""

from repro_torch.serve.graph import GraphServingEngine, QueryTicket, ServeStats

__all__ = ["GraphServingEngine", "QueryTicket", "ServeStats"]

"""Serving (PyTorch port of ``repro.serve``): multi-tenant graph-query
serving, slot-batched waves of B queries over one shared graph
(``serve/graph.py``), and batched LM serving, waves of requests decoded in
lockstep (``serve/engine.py``; its stats are ``engine.ServeStats``)."""

from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.graph import GraphServingEngine, QueryTicket, ServeStats

__all__ = ["GraphServingEngine", "QueryTicket", "Request", "ServeStats",
           "ServingEngine"]

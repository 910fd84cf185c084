"""VeilGraph on PyTorch and CUDA: the port of the JAX package ``repro``.

The session front door lives in :mod:`repro_torch.api`.  Entry points run
on the CUDA device unless the caller passes ``device=``; the hand-written
kernels behind every push (the SpMV push for PageRank, the min/max push for
the traversal workloads) are built from ``kernels/spmv/csrc`` at first
use.
"""

from repro_torch.api import (Action, QueryResult, VeilGraphSession,
                             available_algorithms, serve_session, session)

__all__ = ["Action", "QueryResult", "VeilGraphSession",
           "available_algorithms", "serve_session", "session"]

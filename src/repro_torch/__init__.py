"""VeilGraph on PyTorch and CUDA: the port of the JAX package ``repro``.

The front doors live in :mod:`repro_torch.api`: ``session`` for one
streaming query workload, ``serve_session`` for slot-batched serving of
many.  Entry points run on the CUDA device unless the caller passes
``device=``; the hand-written kernels behind every push (the SpMV push for
the sum algorithms, the min/max push for the traversal workloads, and the
batched form of each for serving waves) are built from
``kernels/spmv/csrc`` at first use.  The LM substrate's dense GQA, MoE
and SSM (Mamba2) models are served by :class:`repro_torch.serve.ServingEngine` (``models/``,
``launch/serve.py``), every attention call through the hand-written
``kernels/flash_attention`` and ``kernels/decode_attention``.
"""

from repro_torch.api import (Action, QueryResult, VeilGraphSession,
                             available_algorithms, serve_session, session)

__all__ = ["Action", "QueryResult", "VeilGraphSession",
           "available_algorithms", "serve_session", "session"]

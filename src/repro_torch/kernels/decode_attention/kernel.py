"""Decode attention: the hand-written Hopper kernel and its plain PyTorch
version.

:func:`decode_attention` attends one new query token per sequence, q ``(B,
1, H, hd)``, over a KV cache, k ``(B, S, KV, hd)`` and v ``(B, S, KV,
vd)``, with GQA groups (``G = H / KV``); slots at or past ``min(cache_len,
S)`` are masked, q is scaled by ``hd^-0.5`` in its own dtype and then
widened (the model's order; the Pallas kernel widens first, one bf16
rounding of ``scale * q`` apart), the sums are f32 and the output ``(B, 1,
H, vd)`` is in q's dtype.  It replaces the Pallas
kernel ``repro/kernels/decode_attention/kernel.py::decode_attention_kernel``,
and on the model path the full-row jnp softmax that stands in for it
(``repro/models/layers.py::decode_attention``).  The CUDA source
(``csrc/decode_attention.cu``: one launch, a thread-block cluster per (b,
KV head, row chunk) whose CTAs split the valid slots and merge their
softmax states through distributed shared memory) says how and what bounds
it; :func:`launch_grid` gives its grid.

On a CUDA tensor the wrapper launches the kernel or raises; only a tensor
that lies on the CPU takes :func:`decode_attention_plain`.  The source is
built at first use by :mod:`repro_torch.kernels.build`; nothing is compiled
or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels.build import current_stream, load_entry
# the (hd, vd) pairs of ATTN_FOR_EACH_DIMS, which both sources build
from repro_torch.kernels.flash_attention.kernel import HEAD_DIM_PAIRS

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30
#: CTAs of one thread-block cluster (``kCluster`` in the source): they split
#: the valid slots of one (b, KV head, row chunk), their shares computed on
#: the device from ``cache_len``
CLUSTER = 8
#: slots a warp stages and scores per step (``kChunk``)
SLOTS_PER_CHUNK = 32
#: query heads of a group per cluster (``kRows``; a wider group takes
#: several row chunks)
ROWS_PER_BLOCK = 8

_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6
             + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))


def launch_grid(batch: int, num_heads: int, num_kv: int
                ) -> Tuple[int, int, int]:
    """The kernel's grid (CTAs in x, y, z) for ``batch`` sequences and GQA
    heads ``num_heads`` over ``num_kv``: one cluster of :data:`CLUSTER` CTAs
    per (b, KV head, row chunk).  It depends on neither S nor
    ``cache_len``."""
    chunks = -(-(num_heads // num_kv) // ROWS_PER_BLOCK)
    return CLUSTER, num_kv * chunks, batch


def _shapes(who: str, q, k_cache, v_cache):
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.dim() != 4 \
            or q.shape[1] != 1:
        raise ValueError(f"{who}: q must be (B, 1, H, hd) and the caches "
                         f"(B, S, KV, dim); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, _, h, hd = q.shape
    bk, s, kvh, hdk = k_cache.shape
    if (bk, s, kvh) != tuple(v_cache.shape[:3]) or bk != b or hdk != hd:
        raise ValueError(f"{who}: caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{who}: {h} query heads do not split into groups "
                         f"of {kvh} KV heads")
    return b, h, hd, s, kvh, v_cache.shape[-1]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: Union[int, torch.Tensor], *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """``(B, 1, H, vd)``: attention of one query token per sequence over
    the first ``min(cache_len, S)`` cache slots, in q's dtype.

    q ``(B, 1, H, hd)``, caches ``(B, S, KV, hd)`` and ``(B, S, KV, vd)``,
    one dtype (f32 or bf16 on the card), ``H % KV == 0``; ``cache_len`` an
    int or an int32 scalar tensor on q's device, read by the kernel on the
    device; ``scale`` defaults to ``hd^-0.5`` and ``scale * q`` is rounded
    to q's dtype before it is widened, as in the model's decode
    (``repro/models/layers.py::decode_attention``).  CUDA tensors launch the
    kernel on the current stream (counted in
    ``decode_attention.launches``); it takes contiguous operands with (hd,
    vd) in ``HEAD_DIM_PAIRS`` and raises on anything else.  CPU tensors
    take :func:`decode_attention_plain`.
    """
    who = "decode_attention"
    b, h, hd, s, kvh, vd = _shapes(who, q, k_cache, v_cache)
    scale = hd ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {q.device}")
    if not torch.is_tensor(cache_len):
        cache_len = torch.tensor(int(cache_len), dtype=torch.int32,
                                 device=q.device)
    if cache_len.device != q.device or cache_len.dtype != torch.int32 \
            or cache_len.numel() != 1:
        raise ValueError(f"{who}: cache_len must be one int32 on {q.device}; "
                         f"got {cache_len.dtype}{tuple(cache_len.shape)} on "
                         f"{cache_len.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{who}: {name} is {t.dtype} on {t.device}, q "
                             f"{q.dtype} on {q.device}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{who}: no kernel for {q.dtype}; it takes "
                         f"{sorted(map(str, DTYPE_CODES))}")
    if (hd, vd) not in HEAD_DIM_PAIRS:
        raise ValueError(f"{who}: no kernel for head dims hd={hd}, vd={vd}; "
                         f"it is built for the (hd, vd) pairs "
                         f"{HEAD_DIM_PAIRS}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} must be contiguous and 16-byte "
                             f"aligned")
    grid = launch_grid(b, h, kvh)
    if grid[1] > 65535 or grid[2] > 65535 or s >= 2**31 - SLOTS_PER_CHUNK:
        raise ValueError(f"{who}: shape {tuple(k_cache.shape)} is beyond "
                         f"the kernel's grid")
    if s == 0:
        raise ValueError(f"{who}: no cache slots (S = 0)")
    out = torch.empty((b, 1, h, vd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = load_entry(SOURCE, "decode_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 cache_len.data_ptr(), out.data_ptr(), b, s, h, kvh, hd, vd,
                 float(scale), DTYPE_CODES[q.dtype],
                 current_stream(q.device))
    if err:
        raise RuntimeError(f"{who}: kernel launch failed with CUDA error "
                           f"{err}")
    decode_attention.launches += 1
    return out


#: kernel launches since the last reset (a plain integer)
decode_attention.launches = 0


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           cache_len: Union[int, torch.Tensor], *,
                           scale: Optional[float] = None,
                           dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """The plain PyTorch version of :func:`decode_attention`: the
    reference's full-row softmax (``repro/models/layers.py::
    decode_attention``) over the S slots, those at or past ``min(cache_len,
    S)`` masked at -1e30, with q scaled in its own dtype and then
    widened.

    It computes in f32 and returns q's dtype; ``dtype=torch.float64``
    computes and returns f64, the oracle the kernel is held against.
    """
    b, h, hd, s, kvh, vd = _shapes("decode_attention_plain", q, k_cache,
                                   v_cache)
    ct = torch.float32 if dtype is None else dtype
    scale = hd ** -0.5 if scale is None else scale
    valid = torch.clamp(torch.as_tensor(cache_len, device=q.device), max=s)
    qg = (q[:, 0].reshape(b, kvh, h // kvh, hd) * scale).to(ct)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(ct))
    slot_ok = torch.arange(s, device=q.device) < valid
    scores = torch.where(slot_ok, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(ct))
    return out.reshape(b, 1, h, vd).to(q.dtype if dtype is None else ct)

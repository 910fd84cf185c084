"""Flash attention forward: the hand-written Hopper kernel and its plain
PyTorch version.

:func:`flash_attention` computes exact softmax attention of q ``(B, Sq, H,
hd)`` over k ``(B, Skv, KV, hd)`` and v ``(B, Skv, KV, vd)`` with GQA (the
``G = H / KV`` query heads of a group share one KV head), causal and
sliding-window masks from the positions (``j <= i``; ``j > i - window``),
the scale (``hd^-0.5`` by default) and f32 accumulation; the output ``(B,
Sq, H, vd)`` is in q's dtype.  The plain version and the f32 kernel (CUDA
cores) scale q widened to f32 before ``q·k``, as the reference; the bf16
kernel (tensor cores) takes ``q·k`` of the raw bf16 inputs, exact in f32,
and scales that score, and its P enters ``P·V`` as two bf16 terms (about
16 bits kept).  It replaces the Pallas kernel
``repro/kernels/flash_attention/kernel.py::flash_attention``, and on the
model path the jnp scan that stands in for it
(``repro/models/layers.py::blocked_attention`` at static offsets).  The
CUDA source (``csrc/flash_attention.cu``) says how and what bounds it.

On a CUDA tensor the wrapper launches the kernel or raises; only a tensor
that lies on the CPU takes :func:`flash_attention_plain`.  The source is
built at first use by :mod:`repro_torch.kernels.build`; nothing is compiled
or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import current_stream, load_entry

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
#: head dims (hd and vd) the kernel is built for
HEAD_DIMS = (16, 32, 64, 128)
#: dtype -> the code the CUDA entry takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the reference's mask value (finite: see the CUDA source)
NEG_INF = -1e30

_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 9
             + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))


def _shapes(who: str, q, k, v):
    """``(b, sq, h, hd, skv, kvh, vd)``, after checking that the three
    operands describe one GQA attention."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{who}: q, k, v must be 4-D (B, S, heads, dim); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, hd = q.shape
    bk, skv, kvh, hdk = k.shape
    if (bk, skv, kvh) != tuple(v.shape[:3]) or bk != b or hdk != hd:
        raise ValueError(f"{who}: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{who}: {h} query heads do not split into groups "
                         f"of {kvh} KV heads")
    return b, sq, h, hd, skv, kvh, v.shape[-1]


def _check_window(who: str, window) -> None:
    if window is not None and window < 1:
        raise ValueError(f"{who}: window must be None or >= 1; got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_block: int = 128,
                    kv_block: int = 512) -> torch.Tensor:
    """``(B, Sq, H, vd)``: softmax attention of q over k, v in q's dtype.

    q ``(B, Sq, H, hd)``, k ``(B, Skv, KV, hd)``, v ``(B, Skv, KV, vd)``,
    one dtype (f32 or bf16 on the card), ``H % KV == 0``; ``scale``
    defaults to ``hd^-0.5``.  CUDA tensors launch the kernel on the current
    stream (counted in ``flash_attention.launches``); it takes contiguous
    operands with hd and vd in :data:`HEAD_DIMS` and raises on anything
    else.  CPU tensors take :func:`flash_attention_plain`, whose tiles are
    ``q_block`` by ``kv_block`` (the kernel chooses its own).
    """
    who = "flash_attention"
    b, sq, h, hd, skv, kvh, vd = _shapes(who, q, k, v)
    _check_window(who, window)
    scale = hd ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_block=q_block,
                                     kv_block=kv_block)
    if q.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{who}: {name} is {t.dtype} on {t.device}, q "
                             f"{q.dtype} on {q.device}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{who}: no kernel for {q.dtype}; it takes "
                         f"{sorted(map(str, DTYPE_CODES))}")
    if hd not in HEAD_DIMS or vd not in HEAD_DIMS:
        raise ValueError(f"{who}: no kernel for head dims hd={hd}, vd={vd}; "
                         f"it is built for {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} must be contiguous and 16-byte "
                             f"aligned")
    if skv == 0:
        raise ValueError(f"{who}: no keys (Skv = 0)")
    if b > 65535 or kvh > 65535 or sq * (h // kvh) >= 2**31 - 64:
        raise ValueError(f"{who}: shape {tuple(q.shape)} is beyond the "
                         f"kernel's grid")
    out = torch.empty((b, sq, h, vd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = load_entry(SOURCE, "flash_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, skv, h, kvh, hd, vd, int(causal),
                 0 if window is None else int(window), float(scale),
                 DTYPE_CODES[q.dtype], current_stream(q.device))
    if err:
        raise RuntimeError(f"{who}: kernel launch failed with CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    return out


#: kernel launches since the last reset (a plain integer)
flash_attention.launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None, q_block: int = 128,
                          kv_block: int = 512,
                          dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_attention`: the
    reference's tiled online-softmax scan (``repro/models/layers.py``'s
    static-offset flash path, ``_blocked_attention_ref``'s tiles), over
    ``q_block`` by ``kv_block`` tiles with q widened before it is scaled,
    masked scores at -1e30 and ``out = l > 0 ? acc / max(l, 1e-30) : 0``.

    It computes in f32 and returns q's dtype; ``dtype=torch.float64``
    computes and returns f64, the oracle the kernel is held against.
    """
    b, sq, h, hd, skv, kvh, vd = _shapes("flash_attention_plain", q, k, v)
    _check_window("flash_attention_plain", window)
    ct = torch.float32 if dtype is None else dtype
    out_dtype = q.dtype if dtype is None else dtype
    scale = hd ** -0.5 if scale is None else scale
    groups = h // kvh
    dev = q.device
    q_block, kv_block = max(1, min(q_block, sq)), max(1, min(kv_block, skv))
    sq_p = -(-sq // q_block) * q_block
    skv_p = -(-skv // kv_block) * kv_block
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, sq_p - sq))
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, skv_p - skv))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, skv_p - skv))
    nq, nk = sq_p // q_block, skv_p // kv_block
    # (nq, B, KV, G, qb, hd), (nk, B, KV, kvb, hd), (nk, B, KV, kvb, vd)
    qb = q.reshape(b, nq, q_block, kvh, groups, hd).permute(1, 0, 3, 4, 2, 5)
    kb = k.reshape(b, nk, kv_block, kvh, hd).permute(1, 0, 3, 2, 4)
    vb = v.reshape(b, nk, kv_block, kvh, vd).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(nq):
        qs = qb[qi].to(ct) * scale
        q_pos = qi * q_block + torch.arange(q_block, device=dev)
        acc = torch.zeros((b, kvh, groups, q_block, vd), dtype=ct, device=dev)
        m_run = torch.full((b, kvh, groups, q_block), NEG_INF, dtype=ct,
                           device=dev)
        l_run = torch.zeros((b, kvh, groups, q_block), dtype=ct, device=dev)
        for ki in range(nk):
            k_pos = ki * kv_block + torch.arange(kv_block, device=dev)
            mask = (k_pos < skv)[None, :].expand(q_block, kv_block)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            s = torch.einsum("bkgqd,bkcd->bkgqc", qs, kb[ki].to(ct))
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bkcd->bkgqd", p, vb[ki].to(ct))
            m_run = m_new
        l_ = l_run[..., None]
        outs.append(torch.where(l_ > 0, acc / torch.clamp(l_, min=1e-30),
                                0.0))
    out = torch.stack(outs)                    # (nq, B, KV, G, qb, vd)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq_p, h, vd)[:, :sq]
    return out.to(out_dtype)

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

Training: ``flash_attention(..., return_lse=True)`` also returns each
row's log-sum-exp and the output in f32 (the residuals the reference's
custom_vjp saves), :func:`flash_attention_bwd` launches the hand-written
backward (``csrc/flash_attention_bwd.cu``: dq, dk, dv, in two passes
without atomics; bf16 on the tensor cores, with dS and dO entering their
products as three bf16 terms each and P as two, f32 on the CUDA cores)
and :class:`FlashAttention` ties the two into autograd.
:func:`flash_attention_bwd_plain` ports the reference's ``flash_bwd``.

Dynamic offsets: :func:`flash_attention_dynamic` and
:func:`flash_attention_bwd_dynamic` launch the same sources built with
``-DATTN_DYNAMIC`` (a library of their own), which read ``q_offset``,
``kv_offset`` and ``kv_valid_len`` (:class:`Offsets`) on the device: the
path of the reference's ``blocked_attention`` that takes them
(``_blocked_attention_ref``), under autograd through the same
:class:`FlashAttention`.  Query row ``i`` sits at ``q_offset + i``, key
``j`` at ``kv_offset + j``; the masks compare those positions, keys at
``kv_offset + j >= kv_valid_len`` are masked, and so are only the keys ``j
>= Skv`` past the inputs (the reference's scan also masks the last
``kv_offset`` real keys when Skv is no multiple of its tile; the port does
not copy that fault).  A row that sees no key outputs 0.

On a CUDA tensor each wrapper launches its kernel or raises; only a tensor
that lies on the CPU takes the plain version.  The sources are built at
first use by :mod:`repro_torch.kernels.build`; nothing is compiled or
loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.kernels.build import current_stream, load_entry

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
#: head dims whose every (hd, vd) pair the kernels are built for
HEAD_DIMS = (16, 32, 64, 128)
#: the (hd, vd) pairs of the forward, backward and decode kernels
#: (``ATTN_FOR_EACH_DIMS``): those, and the hybrid family's (112, 112) and
#: MLA's (96, 64) and (24, 16)
HEAD_DIM_PAIRS = (tuple((hd, vd) for hd in HEAD_DIMS for vd in HEAD_DIMS)
                  + ((24, 16), (96, 64), (112, 112)))
#: dtype -> the code the CUDA entry takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the reference's mask value (finite: see the CUDA source)
NEG_INF = -1e30

_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 9
             + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 9
                 + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
# the dynamic entries take the offsets' pointer after their last tensor
_DYN_ARGTYPES = _ARGTYPES[:5] + (ctypes.c_void_p,) + _ARGTYPES[5:]
_DYN_BWD_ARGTYPES = _BWD_ARGTYPES[:11] + (ctypes.c_void_p,) + _BWD_ARGTYPES[11:]
#: the define that builds the dynamic entries (one library per source)
DYNAMIC_DEFINES = ("ATTN_DYNAMIC=1",)
#: the dynamic entries take Sq, Skv and a window below this (the kernels
#: clamp the offsets' difference to 2^29, which then moves no mask)
DYNAMIC_LIMIT = 1 << 28
_INT32_MAX = 2**31 - 1


class Offsets(NamedTuple):
    """``blocked_attention``'s dynamic offsets: the position of the first
    query row and of the first key, each a Python int or a 0-d integer
    tensor on the call's device, and the position at which keys stop being
    valid (a 0-d integer tensor, an int, or None for no such limit)."""
    q_offset: Any = 0
    kv_offset: Any = 0
    kv_valid_len: Any = None


def offsets_tensor(offsets: Offsets, device: torch.device) -> torch.Tensor:
    """int32[3] on ``device``, ``(q_offset, kv_offset, kv_valid_len)``
    (no limit: 2^31 - 1), built without reading anything back to the host:
    the dynamic kernels read it there."""
    parts = []
    for name, x in zip(Offsets._fields, offsets):
        if x is None:
            x = _INT32_MAX
        if isinstance(x, torch.Tensor):
            if x.numel() != 1 or x.dtype.is_floating_point or (
                    x.device != device):
                raise ValueError(f"flash attention: {name} must be an int or "
                                 f"a one-element integer tensor on {device}; "
                                 f"got {x.dtype} {tuple(x.shape)} on "
                                 f"{x.device}")
            parts.append(x.reshape(()).to(torch.int32))
        else:
            if not -2**31 <= int(x) <= _INT32_MAX:
                raise ValueError(f"flash attention: {name} {x} is beyond "
                                 f"int32")
            parts.append(torch.full((), int(x), dtype=torch.int32,
                                    device=device))
    return torch.stack(parts)


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


def _check_cuda_operands(who: str, named, dtype: torch.dtype) -> None:
    """Raise unless every ``(name, tensor)`` is ``dtype`` on the first
    one's CUDA device, contiguous and 16-byte aligned."""
    dev = named[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{who}: unsupported device {dev}")
    for name, t in named:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{who}: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} must be contiguous and 16-byte "
                             f"aligned")


def _check_kernel_shape(who: str, q, b, sq, h, hd, skv, kvh, vd) -> None:
    """Raise unless the kernel is built for this dtype, these head dims
    (one of :data:`HEAD_DIM_PAIRS`) and this grid."""
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{who}: no kernel for {q.dtype}; it takes "
                         f"{sorted(map(str, DTYPE_CODES))}")
    if (hd, vd) not in HEAD_DIM_PAIRS:
        raise ValueError(f"{who}: no kernel for head dims hd={hd}, vd={vd}; "
                         f"it is built for the (hd, vd) pairs "
                         f"{HEAD_DIM_PAIRS}")
    if skv == 0:
        raise ValueError(f"{who}: no keys (Skv = 0)")
    if b > 65535 or kvh > 65535 or sq * (h // kvh) >= 2**31 - 64:
        raise ValueError(f"{who}: shape {tuple(q.shape)} is beyond the "
                         f"kernel's grid")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_block: int = 128,
                    kv_block: int = 512, return_lse: bool = False):
    """``(B, Sq, H, vd)``: softmax attention of q over k, v in q's dtype.

    q ``(B, Sq, H, hd)``, k ``(B, Skv, KV, hd)``, v ``(B, Skv, KV, vd)``,
    one dtype (f32 or bf16 on the card), ``H % KV == 0``; ``scale``
    defaults to ``hd^-0.5``.  CUDA tensors launch the kernel on the current
    stream (counted in ``flash_attention.launches``, and those with
    ``return_lse`` also in ``flash_attention.lse_launches``); it takes
    contiguous operands with (hd, vd) in :data:`HEAD_DIM_PAIRS` and raises
    on anything else.  CPU tensors take :func:`flash_attention_plain`, whose
    tiles are ``q_block`` by ``kv_block`` (the kernel chooses its own).

    With ``return_lse`` it returns ``(out, lse)``, the backward's
    residuals: ``out`` in f32 whatever q's dtype, and each row's
    log-sum-exp of the scaled scores ``(B, H, Sq)`` in f32 (``+inf`` for a
    row that saw no key).
    """
    who = "flash_attention"
    b, sq, h, hd, skv, kvh, vd = _shapes(who, q, k, v)
    _check_window(who, window)
    scale = hd ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_block=q_block,
                                     kv_block=kv_block,
                                     return_lse=return_lse)
    out, lse, launched = _launch_fwd(who, q, k, v, causal, window, scale,
                                     return_lse, None)
    flash_attention.launches += launched
    if return_lse:
        flash_attention.lse_launches += launched
        return out, lse
    return out


def _launch_fwd(who, q, k, v, causal, window, scale, return_lse, offsets):
    """Check the CUDA operands, allocate ``(out, lse)`` and launch the
    static entry, or the dynamic one on ``offsets`` (int32[3] on the
    device): ``(out, lse, launched)``, lse None without ``return_lse``,
    ``launched`` 0 for an empty output, else 1."""
    b, sq, h, hd, skv, kvh, vd = _shapes(who, q, k, v)
    _check_cuda_operands(who, (("q", q), ("k", k), ("v", v)), q.dtype)
    _check_kernel_shape(who, q, b, sq, h, hd, skv, kvh, vd)
    out = torch.empty((b, sq, h, vd), device=q.device,
                      dtype=torch.float32 if return_lse else q.dtype)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return out, lse, 0
    args = (b, sq, skv, h, kvh, hd, vd, int(causal),
            0 if window is None else int(window), float(scale),
            DTYPE_CODES[q.dtype], current_stream(q.device))
    with torch.cuda.device(q.device):
        if offsets is None:
            fn = load_entry(SOURCE, "flash_attention_fwd", _ARGTYPES)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), None if lse is None else lse.data_ptr(),
                     *args)
        else:
            fn = load_entry(SOURCE, "flash_attention_fwd_dynamic",
                            _DYN_ARGTYPES, DYNAMIC_DEFINES)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), offsets.data_ptr(),
                     *args)
    if err:
        raise RuntimeError(f"{who}: kernel launch failed with CUDA error "
                           f"{err}")
    return out, lse, 1


#: kernel launches since the last reset (plain integers): all of them, and
#: those that also wrote the log-sum-exp (the training forward)
flash_attention.launches = 0
flash_attention.lse_launches = 0


def _check_dynamic(who: str, sq: int, skv: int, window) -> None:
    if max(sq, skv, window or 0) >= DYNAMIC_LIMIT:
        raise ValueError(f"{who}: the dynamic entries take Sq, Skv and the "
                         f"window below {DYNAMIC_LIMIT}; got {sq}, {skv}, "
                         f"{window}")


def flash_attention_dynamic(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, offsets: Offsets, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None,
                            q_block: int = 128, kv_block: int = 512):
    """``(out, lse)``: :func:`flash_attention` with ``return_lse=True`` at
    dynamic :class:`Offsets` (the module's docstring says what they mean),
    ``out`` f32 ``(B, Sq, H, vd)`` and ``lse`` ``(B, H, Sq)`` whatever q's
    dtype.  CUDA tensors launch the dynamic entry, which reads the offsets
    on the device (counted in ``flash_attention_dynamic.launches``); CPU
    tensors take :func:`flash_attention_plain` with ``offsets``."""
    who = "flash_attention_dynamic"
    b, sq, h, hd, skv, kvh, vd = _shapes(who, q, k, v)
    _check_window(who, window)
    _check_dynamic(who, sq, skv, window)
    scale = hd ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_block=q_block,
                                     kv_block=kv_block, return_lse=True,
                                     offsets=offsets)
    out, lse, launched = _launch_fwd(who, q, k, v, causal, window, scale,
                                     True, offsets_tensor(offsets, q.device))
    flash_attention_dynamic.launches += launched
    return out, lse


#: dynamic-entry launches since the last reset
flash_attention_dynamic.launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None, q_block: int = 128,
                          kv_block: int = 512,
                          dtype: Optional[torch.dtype] = None,
                          return_lse: bool = False,
                          offsets: Optional[Offsets] = None):
    """The plain PyTorch version of :func:`flash_attention`: the
    reference's tiled online-softmax scan (``repro/models/layers.py``'s
    static-offset flash path, ``_blocked_attention_ref``'s tiles), over
    ``q_block`` by ``kv_block`` tiles with q widened before it is scaled,
    masked scores at -1e30 and ``out = l > 0 ? acc / max(l, 1e-30) : 0``.

    It computes in f32 (f64 inputs in f64) and returns q's dtype;
    ``dtype=torch.float64`` computes and returns f64, the oracle the kernel
    is held against.  With ``return_lse`` it returns ``(out, lse)`` as
    :func:`flash_attention` does, ``out`` in the compute dtype and ``lse =
    l > 0 ? m + log(max(l, 1e-30)) : inf`` ``(B, H, Sq)``, as the
    reference's ``fwd_impl`` saves them.

    With ``offsets`` it is the plain version of
    :func:`flash_attention_dynamic` (the reference's
    ``_blocked_attention_ref`` without its fault): positions ``q_offset +
    i`` and ``kv_offset + j``, keys at ``kv_offset + j >= kv_valid_len``
    masked, and a row that sees no key outputs 0 with lse ``+inf``.
    """
    b, sq, h, hd, skv, kvh, vd = _shapes("flash_attention_plain", q, k, v)
    _check_window("flash_attention_plain", window)
    ct = _compute_dtype(q, dtype)
    out_dtype = ct if return_lse or dtype is not None else q.dtype
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
    q0, k0, valid = (0, 0, None) if offsets is None else offsets
    outs, lses = [], []
    for qi in range(nq):
        qs = qb[qi].to(ct) * scale
        q_pos = q0 + qi * q_block + torch.arange(q_block, device=dev)
        # rows that saw an allowed key (a dynamic row may see none)
        seen = (None if offsets is None else
                torch.zeros(q_block, dtype=torch.bool, device=dev))
        acc = torch.zeros((b, kvh, groups, q_block, vd), dtype=ct, device=dev)
        m_run = torch.full((b, kvh, groups, q_block), NEG_INF, dtype=ct,
                           device=dev)
        l_run = torch.zeros((b, kvh, groups, q_block), dtype=ct, device=dev)
        for ki in range(nk):
            j = ki * kv_block + torch.arange(kv_block, device=dev)
            mask = _mask(q_pos, k0 + j, j < skv, causal, window, valid)
            if offsets is not None:
                seen = seen | mask.any(dim=-1)
            s = torch.einsum("bkgqd,bkcd->bkgqc", qs, kb[ki].to(ct))
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bkcd->bkgqd", p, vb[ki].to(ct))
            m_run = m_new
        if offsets is not None:
            l_run = torch.where(seen, l_run, 0.0)
        l_ = l_run[..., None]
        outs.append(torch.where(l_ > 0, acc / torch.clamp(l_, min=1e-30),
                                0.0))
        lses.append(torch.where(
            l_run > 0, m_run + torch.log(torch.clamp(l_run, min=1e-30)),
            torch.inf))
    out = torch.stack(outs)                    # (nq, B, KV, G, qb, vd)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq_p, h, vd)[:, :sq]
    if not return_lse:
        return out.to(out_dtype)
    lse = torch.stack(lses)                    # (nq, B, KV, G, qb)
    lse = lse.permute(1, 2, 3, 0, 4).reshape(b, h, sq_p)[:, :, :sq]
    return out.to(out_dtype), lse


def _mask(q_pos, k_pos, in_range, causal, window, valid):
    """(q_blk, k_blk) allowed pairs: keys in range (``j < Skv``), the
    causal and window masks on the positions, and ``k_pos < valid``."""
    mask = in_range[None, :].expand(q_pos.shape[0], k_pos.shape[0])
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    if valid is not None:
        mask = mask & (k_pos < valid)[None, :]
    return mask


def _compute_dtype(q: torch.Tensor, dtype: Optional[torch.dtype]):
    """The plain versions' arithmetic: ``dtype`` if given, else f64 for
    f64 inputs and f32 for the others."""
    if dtype is not None:
        return dtype
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _check_residuals(who: str, b, sq, h, vd, out, lse, dout) -> None:
    for name, t, shape in (("out", out, (b, sq, h, vd)),
                           ("dout", dout, (b, sq, h, vd)),
                           ("lse", lse, (b, h, sq))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{who}: {name} is {tuple(t.shape)}, expected "
                             f"{shape}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, q_block: int = 128,
                        kv_block: int = 512):
    """``(dq, dk, dv)``, in q's dtype: the gradients of
    :func:`flash_attention` at q, k, v given its residuals ``out`` (f32,
    ``(B, Sq, H, vd)``) and ``lse`` (f32, ``(B, H, Sq)``) from
    ``return_lse=True``, and the output's gradient ``dout`` (f32, like
    ``out``).

    CUDA tensors launch the backward kernel's two passes on the current
    stream (one call counted in ``flash_attention_bwd.launches``); the
    masks, scale and head dims are the forward's, and anything the kernel
    does not take raises: (hd, vd) must be in :data:`HEAD_DIM_PAIRS`, as
    for the forward.  Besides ``delta`` ``(B, H, Sq)`` f32, a bf16 call
    allocates a scratch of dO's three bf16 terms ``(3, B, Sq, H, vd)``,
    1.5 times the bytes of ``dout``, which the first pass writes and the
    second reads.  CPU tensors take
    :func:`flash_attention_bwd_plain` over ``q_block`` by ``kv_block``
    tiles.
    """
    grads, launched = _flash_bwd(
        "flash_attention_bwd", q, k, v, out, lse, dout, causal=causal,
        window=window, scale=scale, q_block=q_block, kv_block=kv_block,
        offsets=None)
    flash_attention_bwd.launches += launched
    return grads


#: calls that launched the backward's two passes since the last reset
flash_attention_bwd.launches = 0


def flash_attention_bwd_dynamic(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, out: torch.Tensor,
                                lse: torch.Tensor, dout: torch.Tensor,
                                offsets: Offsets, *, causal: bool = True,
                                window: Optional[int] = None,
                                scale: Optional[float] = None,
                                q_block: int = 128, kv_block: int = 512):
    """``(dq, dk, dv)``: :func:`flash_attention_bwd` of
    :func:`flash_attention_dynamic` at the same :class:`Offsets`.  CUDA
    tensors launch the backward's dynamic entry (counted in
    ``flash_attention_bwd_dynamic.launches``), whose two passes skip by
    the offsets; CPU tensors take :func:`flash_attention_bwd_plain` with
    ``offsets``."""
    grads, launched = _flash_bwd(
        "flash_attention_bwd_dynamic", q, k, v, out, lse, dout,
        causal=causal, window=window, scale=scale, q_block=q_block,
        kv_block=kv_block, offsets=offsets)
    flash_attention_bwd_dynamic.launches += launched
    return grads


#: dynamic-entry calls since the last reset
flash_attention_bwd_dynamic.launches = 0


def _flash_bwd(who, q, k, v, out, lse, dout, *, causal, window, scale,
               q_block, kv_block, offsets):
    """The two backward wrappers: ``((dq, dk, dv), launched)``."""
    b, sq, h, hd, skv, kvh, vd = _shapes(who, q, k, v)
    _check_window(who, window)
    _check_residuals(who, b, sq, h, vd, out, lse, dout)
    if offsets is not None:
        _check_dynamic(who, sq, skv, window)
    scale = hd ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         scale=scale, q_block=q_block,
                                         kv_block=kv_block,
                                         offsets=offsets), 0
    _check_cuda_operands(who, (("q", q), ("k", k), ("v", v)), q.dtype)
    _check_cuda_operands(who, (("out", out), ("lse", lse), ("dout", dout)),
                         torch.float32)
    if out.device != q.device:
        raise ValueError(f"{who}: residuals on {out.device}, q on "
                         f"{q.device}")
    _check_kernel_shape(who, q, b, sq, h, hd, skv, kvh, vd)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return (dq, dk.zero_(), dv.zero_()), 0
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dout_split = (torch.empty((3, b, sq, h, vd), dtype=torch.bfloat16,
                              device=q.device)
                  if q.dtype == torch.bfloat16 else None)
    tensors = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               None if dout_split is None else dout_split.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    args = (b, sq, skv, h, kvh, hd, vd, int(causal),
            0 if window is None else int(window), float(scale),
            DTYPE_CODES[q.dtype], current_stream(q.device))
    with torch.cuda.device(q.device):
        if offsets is None:
            fn = load_entry(BWD_SOURCE, "flash_attention_bwd", _BWD_ARGTYPES)
            err = fn(*tensors, *args)
        else:
            dyn = offsets_tensor(offsets, q.device)
            fn = load_entry(BWD_SOURCE, "flash_attention_bwd_dynamic",
                            _DYN_BWD_ARGTYPES, DYNAMIC_DEFINES)
            err = fn(*tensors, dyn.data_ptr(), *args)
    if err:
        raise RuntimeError(f"{who}: kernel launch failed with CUDA error "
                           f"{err}")
    return (dq, dk, dv), 1


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True,
                              window: Optional[int] = None,
                              scale: Optional[float] = None,
                              q_block: int = 128, kv_block: int = 512,
                              dtype: Optional[torch.dtype] = None,
                              offsets: Optional[Offsets] = None):
    """The plain PyTorch version of :func:`flash_attention_bwd`: the
    reference's ``flash_bwd`` (``repro/models/layers.py::_make_flash``),
    its two tiled passes over ``q_block`` by ``kv_block`` tiles: ``delta =
    rowsum(dO O)``, ``P = exp(s - lse)`` from the recomputed masked score,
    ``dS = P (dP - delta)``, ``dq = scale dS K`` (pass 1), ``dk = scale
    dS^T Q`` and ``dv = P^T dO`` summed over each KV head's group (pass 2).

    It computes in f32 (f64 inputs in f64) and returns q's dtype;
    ``dtype=torch.float64`` computes and returns f64, the oracle the kernel
    is held against.  With ``offsets``, the masks of
    :func:`flash_attention_dynamic` (those of
    :func:`flash_attention_plain` with ``offsets``).
    """
    who = "flash_attention_bwd_plain"
    b, sq, h, hd, skv, kvh, vd = _shapes(who, q, k, v)
    _check_window(who, window)
    _check_residuals(who, b, sq, h, vd, out, lse, dout)
    ct = _compute_dtype(q, dtype)
    scale = hd ** -0.5 if scale is None else scale
    groups = h // kvh
    dev = q.device
    q_block, kv_block = max(1, min(q_block, sq)), max(1, min(kv_block, skv))
    sq_p = -(-sq // q_block) * q_block
    skv_p = -(-skv // kv_block) * kv_block
    nq, nk = sq_p // q_block, skv_p // kv_block
    pad_q = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, sq_p - sq))
    pad_k = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, skv_p - skv))
    # padded query rows carry dO = 0, so they add nothing (as the
    # reference's, whose padded outputs are sliced away)
    qb = pad_q(q.to(ct)).reshape(b, nq, q_block, kvh, groups, hd).permute(
        1, 0, 3, 4, 2, 5)                      # (nq, B, KV, G, qb, hd)
    dob = pad_q(dout.to(ct)).reshape(b, nq, q_block, kvh, groups,
                                     vd).permute(1, 0, 3, 4, 2, 5)
    ob = pad_q(out.to(ct)).reshape(b, nq, q_block, kvh, groups,
                                   vd).permute(1, 0, 3, 4, 2, 5)
    lb = torch.nn.functional.pad(lse.to(ct), (0, sq_p - sq)).reshape(
        b, kvh, groups, nq, q_block).permute(3, 0, 1, 2, 4)
    kb = pad_k(k.to(ct)).reshape(b, nk, kv_block, kvh, hd).permute(
        1, 0, 3, 2, 4)                         # (nk, B, KV, kvb, hd)
    vb = pad_k(v.to(ct)).reshape(b, nk, kv_block, kvh, vd).permute(
        1, 0, 3, 2, 4)
    delta = (dob * ob).sum(dim=-1)             # (nq, B, KV, G, qb)
    q0, k0, valid = (0, 0, None) if offsets is None else offsets

    def probs(qi, ki):
        q_pos = q0 + qi * q_block + torch.arange(q_block, device=dev)
        j = ki * kv_block + torch.arange(kv_block, device=dev)
        mask = _mask(q_pos, k0 + j, j < skv, causal, window, valid)
        s = torch.einsum("bkgqd,bkcd->bkgqc", qb[qi] * scale, kb[ki])
        s = torch.where(mask, s, NEG_INF)
        return torch.exp(s - lb[qi][..., None])

    def d_scores(qi, ki, p):
        dp = torch.einsum("bkgqd,bkcd->bkgqc", dob[qi], vb[ki])
        return p * (dp - delta[qi][..., None])

    dq = []
    for qi in range(nq):                       # pass 1: dq
        acc = torch.zeros((b, kvh, groups, q_block, hd), dtype=ct,
                          device=dev)
        for ki in range(nk):
            ds = d_scores(qi, ki, probs(qi, ki))
            acc = acc + scale * torch.einsum("bkgqc,bkcd->bkgqd", ds, kb[ki])
        dq.append(acc)
    dk, dv = [], []
    for ki in range(nk):                       # pass 2: dk, dv
        acc_k = torch.zeros((b, kvh, kv_block, hd), dtype=ct, device=dev)
        acc_v = torch.zeros((b, kvh, kv_block, vd), dtype=ct, device=dev)
        for qi in range(nq):
            p = probs(qi, ki)
            acc_v = acc_v + torch.einsum("bkgqc,bkgqd->bkcd", p, dob[qi])
            acc_k = acc_k + scale * torch.einsum(
                "bkgqc,bkgqd->bkcd", d_scores(qi, ki, p), qb[qi])
        dk.append(acc_k)
        dv.append(acc_v)
    out_dtype = q.dtype if dtype is None else dtype
    dq = torch.stack(dq).permute(1, 0, 4, 2, 3, 5).reshape(
        b, sq_p, h, hd)[:, :sq]
    dk = torch.stack(dk).permute(1, 0, 3, 2, 4).reshape(b, skv_p, kvh,
                                                        hd)[:, :skv]
    dv = torch.stack(dv).permute(1, 0, 3, 2, 4).reshape(b, skv_p, kvh,
                                                        vd)[:, :skv]
    return dq.to(out_dtype), dk.to(out_dtype), dv.to(out_dtype)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its hand-written backward, for training: the
    reference's ``custom_vjp`` (``repro/models/layers.py::_make_flash``).
    The forward returns the output in f32 (the caller casts it to q's
    dtype, as the reference casts its f32 result) and saves ``(q, k, v,
    out, lse)``; the backward recomputes P from ``lse`` with
    :func:`flash_attention_bwd`, the kernel on CUDA tensors, the plain
    version on CPU ones.  With :class:`Offsets` (the reference
    differentiates its dynamic scan by autodiff) the two calls are
    :func:`flash_attention_dynamic` and :func:`flash_attention_bwd_dynamic`
    at those offsets."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_block, kv_block,
                offsets=None):
        opts = dict(causal=causal, window=window, scale=scale,
                    q_block=q_block, kv_block=kv_block)
        if offsets is None:
            out, lse = flash_attention(q, k, v, return_lse=True, **opts)
        else:
            out, lse = flash_attention_dynamic(q, k, v, offsets, **opts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts, ctx.offsets = opts, offsets
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.float().contiguous()
        if ctx.offsets is None:
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                             **ctx.opts)
        else:
            dq, dk, dv = flash_attention_bwd_dynamic(
                q, k, v, out, lse, dout, ctx.offsets, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_differentiable(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, *, causal: bool = True,
                                   window: Optional[int] = None,
                                   scale: Optional[float] = None,
                                   q_block: int = 128,
                                   kv_block: int = 512,
                                   offsets: Optional[Offsets] = None
                                   ) -> torch.Tensor:
    """:class:`FlashAttention` applied: the attention output in f32, with
    gradients to q, k and v through the backward kernel (at dynamic
    ``offsets`` if given)."""
    return FlashAttention.apply(q, k, v, causal, window, scale, q_block,
                                kv_block, offsets)

"""Mamba2 mixer: the SSD (state-space duality) chunked scan and the
recurrent decode (the port of ``repro.models.mamba2``).

The depthwise causal conv on (x, B, C), softplus dt, a scalar A per head,
the D skip and the gated RMSNorm, as in the reference.  The chunked scan:

1. within a chunk of Q positions: Y_diag through the masked decay matrix
   L = exp(segsum(dt·A));
2. each chunk's end state: Bᵀ·(decay·x);
3. between chunks: a loop carrying the (H, P, N) state;
4. the carried state's share of each output, Y_off.

Decode is the O(1)-per-token recurrence h ← exp(dt·A)·h + dt·(B ⊗ x),
y = C·h + D·x.  The reference's multi-operand einsums are contracted here
pairwise in a fixed order (``torch.einsum`` would pick its own order),
their products in f32 as the reference's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.sharding import per_shard as PS


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., Q) -> (..., Q, Q) with out[l, s] = Σ_{s < j ≤ l} x_j, and
    -inf above the diagonal (the decay mask's exponent)."""
    q = x.shape[-1]
    cs = x.cumsum(-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return d.masked_fill(~mask, float("-inf"))


def _split(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """(z, x, BC, dt, d_inner, G·N, heads) of the input projection's
    output."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state
    nh = s.num_heads(cfg.d_model)
    z, xh, bc, dt = zxbcdt.split([di, di, 2 * gn, nh], dim=-1)
    return z, xh, bc, dt, di, gn, nh


#: the small per-layer leaves an SSD region reads whole on every rank
_REGION_LEAVES = ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip", "norm")


def _per_batch_shard(fn, cfg: ModelConfig, p, zxbcdt: torch.Tensor,
                     caches=(), outs: int = 1):
    """``fn(zxbcdt, caches..., leaves)`` as an SSD region: per batch
    shard on DTensor inputs (the heads of each shard whole: the
    reference's ``ws`` of x over ``ssm_heads`` is the region's spec
    here, which keeps them on every rank), the leaves of
    :data:`_REGION_LEAVES` replicated; on plain tensors, the call itself.
    ``caches`` are updated in place (a cache laid out otherwise is
    redistributed for the call and written back)."""
    leaves = tuple(p[k] for k in _REGION_LEAVES)
    mesh = PS.mesh_of(zxbcdt)
    spec = None if mesh is None else PS.batch_spec(mesh, zxbcdt.shape)
    held = [PS.held_as(c, None if spec is None
                       else spec + (None,) * (c.ndim - len(spec)), mesh)
            for c in caches]
    out = PS.run(
        lambda z, *rest: fn(z, *rest[:len(caches)],
                            dict(zip(_REGION_LEAVES, rest[len(caches):]))),
        (zxbcdt, *(h for h, _ in held), *leaves),
        (spec,) + tuple(None if spec is None else
                        spec + (None,) * (c.ndim - len(spec))
                        for c in caches) + ((),) * len(leaves),
        spec if outs == 1 else [spec] * outs)
    for _, back in held:
        back()
    return out


def _causal_conv_full(xbc: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S, then SiLU.  xbc: (B, S, C); w: (k,
    C); b: (C,); weights in the activation dtype, the k shifted products
    summed in order as the reference."""
    k = w.shape[0]
    w, b = w.to(xbc.dtype), b.to(xbc.dtype)
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + pad[:, i:i + xbc.shape[1]] * w[i]
    return F.silu(out + b)


def _dt_and_a(p, dt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """softplus(dt + dt_bias) and A = -exp(a_log), both f32."""
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["a_log"].float())


def _heads(m: torch.Tensor, groups: int, nh: int) -> torch.Tensor:
    """(..., G·N) -> (..., H, N): each group's B or C for its heads."""
    m = m.reshape(m.shape[:-1] + (groups, -1))
    return m.repeat_interleave(nh // groups, dim=-2)


def _gated_norm(p, y: torch.Tensor, z: torch.Tensor, dtype: torch.dtype,
                cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(y.to(dtype) * F.silu(z), p["norm"], cfg.norm_eps)


def mamba2_full(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence SSD.  x: (B, S, d) -> (B, S, d)."""
    return mamba2_from_proj(p, x @ p["in_proj"].to(x.dtype), x.dtype, cfg)


def mamba2_from_proj(p: Dict[str, torch.Tensor], zxbcdt: torch.Tensor,
                     dtype: torch.dtype, cfg: ModelConfig) -> torch.Tensor:
    """:func:`mamba2_full` from the input projection's output (B, S, ·) of
    an input in ``dtype`` (a prefill takes its final state from the same
    projection, where XLA merges the reference's two)."""
    y = _per_batch_shard(lambda zx, lp: _ssd(lp, zx, dtype, cfg), cfg, p,
                         zxbcdt)
    return y @ p["out_proj"].to(dtype)


def _ssd(p, zxbcdt: torch.Tensor, dtype: torch.dtype,
         cfg: ModelConfig) -> torch.Tensor:
    """The SSD chunked scan of one shard's projection output (B, S, ·):
    the gated, normed output (B, S, d_inner) in ``dtype``."""
    s_cfg = cfg.ssm
    b, s, _ = zxbcdt.shape
    z, xh, bc, dt, di, gn, nh = _split(zxbcdt, cfg)
    xbc = _causal_conv_full(torch.cat([xh, bc], -1), p["conv_w"],
                            p["conv_b"])
    xh, bmat, cmat = xbc.split([di, gn, gn], dim=-1)

    n, hp = s_cfg.d_state, s_cfg.head_dim
    q = min(s_cfg.chunk_size, s)
    s_orig = s
    if s % q:  # pad the tail to a chunk multiple; sliced off at the end
        pad = q - s % q
        xh, bmat, cmat, dt, z = (F.pad(t, (0, 0, 0, pad))
                                 for t in (xh, bmat, cmat, dt, z))
        s += pad
    nc = s // q

    dt, a = _dt_and_a(p, dt)
    g = s_cfg.n_groups
    hpg = nh // g
    da = (dt * a).reshape(b, nc, q, nh).permute(0, 3, 1, 2)   # (B,H,nc,Q)
    # B and C stay per group (a group's heads share them): every product
    # of the reference's per-head copies is the same per group
    bmat = bmat.reshape(b, nc, q, g, n).float()
    cmat = cmat.reshape(b, nc, q, g, n).float()
    x_dt = (xh.reshape(b, nc, q, nh, hp).float()
            * dt.reshape(b, nc, q, nh)[..., None])            # (B,nc,Q,H,P)

    # 1. within each chunk: ((C·Bᵀ) ∘ L) · (dt·x), contracted in that order
    cb = torch.matmul(cmat.transpose(2, 3),
                      bmat.permute(0, 1, 3, 4, 2))            # (B,nc,G,Q,Q)
    ell = torch.exp(_segsum(da)).transpose(1, 2)              # (B,nc,H,Q,Q)
    ell = (ell.reshape(b, nc, g, hpg, q, q) * cb[:, :, :, None]).reshape(
        b, nc, nh, q, q)
    y = torch.matmul(ell, x_dt.transpose(2, 3))               # (B,nc,H,Q,P)
    del cb, ell

    # 2. each chunk's end state: Bᵀ · (decay-to-end · dt·x)
    da_cum = da.cumsum(-1)                                    # (B,H,nc,Q)
    decay_to_end = torch.exp(da_cum[..., -1:] - da_cum)
    xd = x_dt * decay_to_end.permute(0, 2, 3, 1)[..., None]   # (B,nc,Q,H,P)
    states = torch.matmul(
        xd.reshape(b, nc, q, g, hpg * hp).permute(0, 1, 3, 4, 2),
        bmat.transpose(2, 3)).reshape(b, nc, nh, hp, n)       # (B,nc,H,P,N)
    del xd

    # 3. between chunks: the state entering each chunk
    chunk_decay = torch.exp(da_cum[..., -1])                  # (B,H,nc)
    h = torch.zeros((b, nh, hp, n), dtype=torch.float32,
                    device=zxbcdt.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, :, c, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, 1).reshape(b, nc, g, hpg * hp, n)

    # 4. the entering state's share: (C · h) ∘ decay-from-start
    y_off = torch.matmul(cmat.transpose(2, 3), h_prevs.transpose(-1, -2))
    y_off = y_off.reshape(b, nc, g, q, hpg, hp).transpose(3, 4).reshape(
        b, nc, nh, q, hp)                                     # (B,nc,H,Q,P)
    in_decay = torch.exp(da_cum).permute(0, 2, 1, 3)          # (B,nc,H,Q)
    y = y + y_off * in_decay[..., None]

    y = y.permute(0, 1, 3, 2, 4).reshape(b, s, nh, hp)
    y = y + xh.reshape(b, s, nh, hp).float() * p["d_skip"].float()[:, None]
    y = y.reshape(b, s, di)[:, :s_orig]
    return _gated_norm(p, y, z[:, :s_orig], dtype, cfg)


def mamba2_init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                      device=None) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    d = cfg.d_model
    return {
        "conv": torch.zeros((batch, s.conv_kernel - 1, s.conv_dim(d)),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, s.num_heads(d), s.head_dim, s.d_state),
                           dtype=dtype, device=device),
    }


def mamba2_decode(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  cache: Dict[str, torch.Tensor], cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step, x: (B, 1, d).  Updates ``cache`` (its
    ``conv`` (B, k-1, C) and ``ssm`` (B, H, P, N) tensors) in place and
    returns it with the output."""
    y = _per_batch_shard(
        lambda zx, conv, ssm, lp: _recur(lp, zx, conv, ssm, x.dtype, cfg),
        cfg, p, x @ p["in_proj"].to(x.dtype),
        caches=(cache["conv"], cache["ssm"]))
    return y @ p["out_proj"].to(x.dtype), cache


def _recur(p, zxbcdt: torch.Tensor, conv: torch.Tensor, ssm: torch.Tensor,
           dtype: torch.dtype, cfg: ModelConfig) -> torch.Tensor:
    """One shard's recurrent step from its projection output (B, 1, ·):
    updates the ``conv`` and ``ssm`` caches in place, returns the gated,
    normed output (B, 1, d_inner) in ``dtype``."""
    s_cfg = cfg.ssm
    b = zxbcdt.shape[0]
    z, xh, bc, dt, di, gn, nh = _split(zxbcdt, cfg)
    n, hp = s_cfg.d_state, s_cfg.head_dim
    cache = {"conv": conv, "ssm": ssm}

    # the conv window: the cached k-1 inputs and the new one
    hist = torch.cat([cache["conv"],
                      torch.cat([xh, bc], -1).to(cache["conv"].dtype)], 1)
    conv_out = (hist.float() * p["conv_w"].float()).sum(1)
    conv_out = F.silu(conv_out + p["conv_b"].float())         # (B, C)
    cache["conv"].copy_(hist[:, 1:])

    xh_c, bvec, cvec = conv_out.split([di, gn, gn], dim=-1)
    bvec = _heads(bvec, s_cfg.n_groups, nh)                   # (B,H,N)
    cvec = _heads(cvec, s_cfg.n_groups, nh)
    dt1, a = _dt_and_a(p, dt[:, 0])                           # (B,H)
    xh_h = xh_c.reshape(b, nh, hp)
    dbx = (dt1[..., None] * xh_h)[..., None] * bvec[:, :, None, :]
    h = cache["ssm"]
    h.mul_(torch.exp(dt1 * a)[..., None, None]).add_(dbx)
    y = torch.matmul(h, cvec[..., None])[..., 0]              # (B,H,P)
    y = y + xh_h * p["d_skip"].float()[None, :, None]
    return _gated_norm(p, y.reshape(b, 1, di), z, dtype, cfg)

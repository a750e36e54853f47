"""Mixture-of-Experts FFN: top-k (GShard-style) routing with per-group
capacity, group = batch row.

Counterpart of ``repro.models.moe`` in plain PyTorch and in the same
arithmetic: the router in float32, the expert products in the
activations' dtype (bf16) with ``silu`` taken in float32, the combine a
scatter-add in the activations' dtype.  Arctic's dense-residual kind
(``ATTN_MOE_DENSE``) adds a parallel dense SwiGLU outside this module.

Both top-k selections (the experts of a token, the tokens of an expert's
capacity slots) break ties toward the lower index, as ``jax.lax.top_k``
does: they are a stable descending sort whose head is taken, never
``torch.topk``.  Each token has at most ``top_k_experts`` nonzero terms in
the combine (a slot whose gate is 0 adds an exact zero), so with top-2 the
scatter-add gives the same bits in any order of its adds.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import dense_init


class MoE(nn.Module):
    """``moe_init``: the float32 router (d, E) and the experts' SwiGLU
    weights ``wg``, ``wu`` (E, d, ff) and ``wd`` (E, ff, d)."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = dense_init(gen, (d, E))
        self.wg = dense_init(gen, (E, d, ff), 1.0 / math.sqrt(d))
        self.wu = dense_init(gen, (E, d, ff), 1.0 / math.sqrt(d))
        self.wd = dense_init(gen, (E, ff, d),
                             1.0 / math.sqrt(ff * cfg.n_layers))


def capacity(cfg, S: int) -> int:
    """Tokens each expert takes from a batch row of S tokens."""
    return max(1, min(S, int(math.ceil(
        S * cfg.top_k_experts * cfg.capacity_factor / cfg.n_experts))))


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties toward
    the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(p, x: torch.Tensor, cfg):
    """Top-k capacity MoE: x (B, S, d) -> (y (B, S, d), aux loss float32
    scalar).  Each batch row sends each expert its ``capacity(cfg, S)``
    tokens of largest gate; the rest of a row's tokens routed to that
    expert are dropped (they add nothing)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k_experts
    C = capacity(cfg, S)
    cd = x.dtype

    logits = torch.einsum("bsd,de->bse", x.float(), p.router)
    probs = torch.softmax(logits, dim=-1)                     # (B,S,E)
    top_v, top_i = top_k(probs, k)                            # (B,S,k)
    top_v = top_v / torch.clamp_min(top_v.sum(-1, keepdim=True), 1e-9)

    # the gate matrix: the renormalised prob of each chosen expert, else 0
    gates = torch.zeros_like(probs).scatter_(-1, top_i, top_v)
    chosen = torch.zeros_like(probs).scatter_(-1, top_i, 1.0)

    # load-balance aux loss (Switch): E * sum_e(mean prob * token share)
    aux = E * torch.sum(probs.mean(dim=(0, 1)) * chosen.mean(dim=(0, 1)))

    # per-(row, expert) capacity: the C tokens of largest gate
    gv, gi = top_k(gates.transpose(1, 2), C)                  # (B,E,C)
    live = gv > 0.0

    rows = torch.arange(B, device=x.device)[:, None, None]
    xe = x[rows, gi]                                          # (B,E,C,d)
    xe = xe.permute(1, 0, 2, 3).reshape(E, B * C, d)
    h_g = torch.bmm(xe, p.wg.to(cd))                          # (E,B*C,ff)
    h_u = torch.bmm(xe, p.wu.to(cd))
    h = torch.nn.functional.silu(h_g.float()).to(cd) * h_u
    ye = torch.bmm(h, p.wd.to(cd))                            # (E,B*C,d)
    ye = ye.reshape(E, B, C, d).permute(1, 0, 2, 3)
    ye = ye * (gv * live)[..., None].to(cd)
    return combine(ye, gi, S), aux


def combine(ye: torch.Tensor, gi: torch.Tensor, S: int) -> torch.Tensor:
    """Scatter-add each row's expert outputs ye (B, E, C, d) back to its
    tokens gi (B, E, C) in ye's dtype: (B, S, d).  With at most two
    nonzero terms a token (top-2; the rest exact zeros) every order of the
    adds rounds alike, so ``index_add_``'s atomics on the card give the
    CPU's bits."""
    B, _, _, d = ye.shape
    rows = torch.arange(B, device=ye.device)[:, None, None]
    y = torch.zeros((B * S, d), dtype=ye.dtype, device=ye.device)
    y.index_add_(0, (rows * S + gi).reshape(-1), ye.reshape(-1, d))
    return y.reshape(B, S, d)

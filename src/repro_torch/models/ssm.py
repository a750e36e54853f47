"""Mamba-2 block: the state-space duality (SSD) chunked scan.

Counterpart of ``repro.models.ssm`` in plain PyTorch and in the same
arithmetic, step by step:

  * ``_causal_conv``   — the depthwise causal conv as the JAX code unrolls
                         it: W shifted products summed in the input's dtype
                         (bf16) in order, the bias added, ``silu`` taken in
                         float32 (``F.conv1d`` would sum otherwise);
  * ``ssd_chunked``    — prefill: the chunked quadratic-intra /
                         linear-inter scan, float32 throughout; the
                         sequence length must be a multiple of the chunk
                         (it raises otherwise, as the JAX reshape does; no
                         padding);
  * ``ssd_sequential`` — the O(L) recurrence, the tests' oracle;
  * ``mamba_block``    — the whole block; decode (a state and L == 1) is
                         the O(1) recurrent step.

The float32 products assume full float32 matrix products on the card
(``torch.get_float32_matmul_precision() == "highest"``, no TF32).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import dense_init, rms_scale


class Mamba(nn.Module):
    """``mamba_init``: the input and output projections, the depthwise
    conv, and the per-head ``A_log`` = log(linspace(1, 16, heads)), ``D`` =
    1 and ``dt_bias`` = 0; ``conv_b`` = 0 and ``norm_scale`` = 1."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
        nh, w = cfg.ssm_heads, cfg.conv_width
        conv_ch = di + 2 * N
        dev = gen.device
        self.in_proj = dense_init(gen, (d, 2 * di + 2 * N + nh))
        self.conv_w = dense_init(gen, (w, conv_ch), 1.0 / math.sqrt(w))
        self.conv_b = nn.Parameter(torch.zeros(conv_ch, device=dev))
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, nh, device=dev)))
        self.D = nn.Parameter(torch.ones(nh, device=dev))
        self.dt_bias = nn.Parameter(torch.zeros(nh, device=dev))
        self.norm_scale = nn.Parameter(torch.ones(di, device=dev))
        self.out_proj = dense_init(gen, (di, d),
                                   1.0 / math.sqrt(di * cfg.n_layers))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv along the sequence: x (B, L, C), w (W, C),
    b (C,).  With ``state`` (B, W-1, C), the inputs before x (streaming).
    Returns (the conv's output in x's dtype, the new state: the last W-1
    inputs)."""
    W, L = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    new_state = xp[:, -(W - 1):, :]
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + L, :] * w[i]
    y = torch.nn.functional.silu((out + b).float()).to(x.dtype)
    return y, new_state


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Segment sums S[..., l, s] = sum_{j=s+1..l} a[..., j] (l >= s), -inf
    above the diagonal: a (..., cl) -> (..., cl, cl)."""
    cl = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    S = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                 device=a.device))
    return torch.where(mask, S, -math.inf)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                init_state: torch.Tensor | None = None):
    """SSD scan: x (B, L, H, P), dt (B, L, H), A (H,), Bm, Cm (B, L, N)
    (dt, A, Bm, Cm float32).  Returns (y (B, L, H, P) in x's dtype, the
    final state (B, H, P, N) float32)."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    if L % chunk:
        raise ValueError(f"ssd_chunked: sequence length {L} is not a "
                         f"multiple of the chunk {chunk}")
    nc, cl = L // chunk, chunk

    xc = x.reshape(Bsz, nc, cl, H, P)
    dtc = dt.reshape(Bsz, nc, cl, H)
    Bc = Bm.reshape(Bsz, nc, cl, N)
    Cc = Cm.reshape(Bsz, nc, cl, N)

    a = dtc * A                                       # (B,nc,cl,H)
    A_cum = torch.cumsum(a, dim=2)

    # intra-chunk (quadratic, per chunk)
    Lmat = torch.exp(_segsum(a.movedim(-1, 2)))       # (B,nc,H,cl,cl)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    dtx = xc * dtc[..., None]                         # float32
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores[:, :, None] * Lmat,
                          dtx)

    # chunk states
    decay_end = torch.exp(A_cum[:, :, -1:, :] - A_cum)
    S_c = torch.einsum("bcln,bclhp->bchpn", Bc,
                       xc.float() * (decay_end * dtc)[..., None])

    # inter-chunk scan
    chunk_decay = torch.exp(A_cum[:, :, -1, :])       # (B,nc,H)
    s = (init_state.float() if init_state is not None else
         torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device))
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + S_c[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)             # (B,nc,H,P,N)

    # off-diagonal contribution
    y_off = (torch.einsum("bcln,bchpn->bclhp", Cc, s_prevs)
             * torch.exp(A_cum)[..., None])
    y = (y_diag + y_off).reshape(Bsz, L, H, P)
    return y.to(x.dtype), s


def _recurrent_step(s, xt, dtt, A, Bt, Ct):
    """One token of the recurrence: s (B, H, P, N), xt (B, H, P), dtt
    (B, H), Bt, Ct (B, N), all float32.  Returns (new s, y (B, H, P))."""
    dec = torch.exp(dtt * A)
    upd = (dtt[:, :, None] * xt)[..., None] * Bt[:, None, None, :]
    s = s * dec[..., None, None] + upd
    return s, torch.einsum("bhpn,bn->bhp", s, Ct)


def ssd_sequential(x, dt, A, Bm, Cm, init_state=None):
    """The O(L) recurrence (the tests' oracle); as ``ssd_chunked``."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    s = (init_state.float() if init_state is not None else
         torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device))
    ys = []
    for t in range(L):
        s, y = _recurrent_step(s, x[:, t].float(), dt[:, t], A, Bm[:, t],
                               Cm[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), s


def mamba_block(p, x: torch.Tensor, cfg, *, state=None, conv_state=None,
                sequential: bool = False):
    """The Mamba-2 block on x (B, L, d) in the activations' dtype.

    Prefill (``state`` None): the chunked SSD (``sequential``: the
    recurrence); decode (a ``state`` and L == 1): the recurrent step.
    Returns (out (B, L, d), (ssm state (B, H, P, N) float32, conv state
    (B, W-1, d_inner + 2N) in x's dtype))."""
    Bsz, L, _ = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    nh, P = cfg.ssm_heads, cfg.ssm_head_dim
    cd = x.dtype

    zxbcdt = x @ p.in_proj.to(cd)
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * N, nh], dim=-1)
    xBC, new_conv = _causal_conv(xBC, p.conv_w.to(cd), p.conv_b.to(cd),
                                 conv_state)
    x_in, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    x_in = x_in.reshape(Bsz, L, nh, P)
    dt = torch.logaddexp(dt.float() + p.dt_bias,
                         torch.zeros((), device=x.device))   # softplus
    A = -torch.exp(p.A_log)

    if state is not None and L == 1:
        new_state, y = _recurrent_step(state, x_in[:, 0].float(), dt[:, 0],
                                       A, Bm[:, 0].float(),
                                       Cm[:, 0].float())
        y = y[:, None]                                # float32
    elif sequential:
        y, new_state = ssd_sequential(x_in, dt, A, Bm.float(), Cm.float(),
                                      init_state=state)
    else:
        y, new_state = ssd_chunked(x_in, dt, A, Bm.float(), Cm.float(),
                                   cfg.ssm_chunk, init_state=state)

    y = y.float() + x_in.float() * p.D[:, None]
    y = y.reshape(Bsz, L, di)
    # gated RMSNorm (Mamba-2): norm(y * silu(z)), normalised in bf16
    g = y * torch.nn.functional.silu(z.float())
    g = rms_scale(g.to(cd), p.norm_scale, cfg.norm_eps)
    return g @ p.out_proj.to(cd), (new_state, new_conv)

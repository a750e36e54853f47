"""AdamW with optional block-quantized (int8) first/second moments.

Counterpart of ``repro.train.optimizer``, in the same float32 arithmetic
op for op.  The int8 states (blockwise absmax linear quantization, à la
8-bit Adam [arXiv:2110.02861]) cut optimizer memory from 8 to ~2.03
bytes a parameter at the default block of 256 (1 code byte and 4/256
scale bytes per moment); dense configs default to float32 states.

The JAX package holds its parameters as a pytree whose block leaves are
stacked over the pattern's repeats, so a block's norm scale (d,) is a
(n_repeats, d) matrix there: decayed, and int8 under int8 states.  The
port keeps one tensor per repeat; ``ranks`` gives the rank each leaf has
in the JAX tree (:func:`repro_torch.models.convert.jax_ranks`) so the two
packages apply the same rules.  Blocking is along the last axis, so a
per-repeat ``QTensor`` stacked over the repeats is the JAX one.

Divisions by a constant go through :func:`true_div`: on the card
``tensor / python_float`` multiplies by the float32 reciprocal, which is
not the quotient JAX and the CPU compute.

This is not ``torch.optim.AdamW``: the clip is inside the update, decay
falls on matrices only, and the states may be int8.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    state_dtype: str = "fp32"        # "fp32" | "int8"
    q_block: int = 256


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded once, on any device: the divisor is made a 0-d
    tensor on x's device so that no reciprocal is taken."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# blockwise int8 quantization
# ---------------------------------------------------------------------------


class QTensor(NamedTuple):
    codes: torch.Tensor   # int8, (*lead, n_blocks, block): last-axis blocking
    scales: torch.Tensor  # float32, (*lead, n_blocks)
    shape: tuple          # the original shape

    def size_bytes(self) -> int:
        return self.codes.numel() + 4 * self.scales.numel()


def _quantize(x: torch.Tensor, block: int) -> QTensor:
    """Absmax int8 codes of x in blocks of ``block`` along its last axis
    (zero-padded to a whole block), one float32 scale a block.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    shape = tuple(x.shape)
    x = x.float()
    pad = (-shape[-1]) % block
    if pad:
        x = F.pad(x, (0, pad))
    blocks = x.reshape(*shape[:-1], -1, block)
    scales = true_div(torch.amax(torch.abs(blocks), dim=-1), 127.0)
    scales = torch.clamp_min(scales, 1e-12)
    codes = torch.clamp(torch.round(blocks / scales[..., None]), -127, 127)
    return QTensor(codes.to(torch.int8), scales, shape)


def _dequantize(q: QTensor) -> torch.Tensor:
    x = q.codes.float() * q.scales[..., None]
    x = x.reshape(*q.shape[:-1], -1)
    return x[..., : q.shape[-1]]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


class OptState(NamedTuple):
    m: dict          # name -> float32 tensor or QTensor
    v: dict
    count: torch.Tensor   # 0-d int32, on the parameters' device


def _rank(name, p, ranks) -> int:
    return p.ndim if ranks is None else ranks[name]


def init_state(params: dict, cfg: OptConfig, *, ranks=None) -> OptState:
    """Zero moments for ``params`` (name -> tensor): int8 where
    ``cfg.state_dtype`` is "int8" and the leaf's rank is at least 2."""
    def zero_like(name, p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.state_dtype == "int8" and _rank(name, p, ranks) >= 2:
            return _quantize(z, cfg.q_block)
        return z

    m = {n: zero_like(n, p) for n, p in params.items()}
    v = {n: zero_like(n, p) for n, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(m, v, torch.zeros((), dtype=torch.int32, device=dev))


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp_max(true_div(step.float(), max(cfg.warmup_steps, 1)),
                           1.0)
    return cfg.lr * warm


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf
    by leaf in order (a 0-d tensor on the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in leaves))


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: OptState,
                  cfg: OptConfig, *, ranks=None, grad_norm=None):
    """One AdamW step (with de/re-quantization of int8 states), in place:
    each parameter of ``params`` (name -> tensor) and each float32 moment
    of ``state`` is overwritten; int8 moments are replaced.  Returns
    (params, the new OptState, the global norm of ``grads`` before the
    clip).  Every scalar of the schedule stays on the device, so a step
    never waits for the card.

    ``grad_norm`` (a 0-d tensor on the parameters' device) is the norm
    to clip by, where ``params`` are one mesh coordinate's slices and the
    norm is the whole gradient's; else it is taken over ``grads``."""
    count = state.count + 1
    lr = _schedule(cfg, count)
    c1 = 1.0 - cfg.b1 ** count.float()
    c2 = 1.0 - cfg.b2 ** count.float()

    gn = (global_norm(grads[n] for n in params) if grad_norm is None
          else grad_norm)
    clip = torch.clamp_max(
        torch.full_like(gn, cfg.grad_clip) / torch.clamp_min(gn, 1e-9), 1.0)

    new_m, new_v = {}, {}
    for name, p in params.items():
        g = grads[name].float() * clip
        m, v = state.m[name], state.v[name]
        mq = isinstance(m, QTensor)
        if mq:
            m = cfg.b1 * _dequantize(m) + (1 - cfg.b1) * g
            v = cfg.b2 * _dequantize(v) + (1 - cfg.b2) * g * g
        else:
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if _rank(name, p, ranks) >= 2:   # decoupled weight decay, matrices
            u = u + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
        if mq:
            m, v = _quantize(m, cfg.q_block), _quantize(v, cfg.q_block)
        new_m[name], new_v[name] = m, v
    return params, OptState(new_m, new_v, count), gn

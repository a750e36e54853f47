"""Error-feedback gradient compression (int8).

Counterpart of ``repro.train.compression``: the gradient plus the carried
residual is quantized to int8 in flat blocks of 256 and dequantized, and
what the quantization lost is carried to the next step, so the
compression error is re-injected (unbiased in the long run).  In the JAX
package it precedes the data-parallel gradient reduction; on one device
it changes the update only by the quantization, as there.

The JAX package compresses each leaf of its stacked parameter tree, so a
block leaf's flat blocks run across the repeats; the train step hands
these functions the repeats concatenated, as that tree holds them
(:func:`repro_torch.train.train_step.make_train_step`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.train.optimizer import true_div


def quantize_int8(x: torch.Tensor, block: int = 256):
    """x flattened and zero-padded to whole blocks -> (codes int8
    (n_blocks, block), scales float32 (n_blocks,))."""
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scales = torch.clamp_min(
        true_div(torch.amax(torch.abs(blocks), dim=1), 127.0), 1e-12)
    codes = torch.clamp(torch.round(blocks / scales[:, None]), -127, 127)
    return codes.to(torch.int8), scales


def dequantize_int8(codes: torch.Tensor, scales: torch.Tensor, shape):
    flat = (codes.float() * scales[:, None]).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def compress_with_feedback(grads: dict, err: dict):
    """Quantize (grads + err) to int8, each entry on its own; returns
    (dequantized grads, new err), dicts keyed as ``grads``.  ``err`` holds
    float32 residuals shaped as the grads (zeros initially)."""
    g_hat, new_err = {}, {}
    for key, g in grads.items():
        target = g.float() + err[key]
        codes, scales = quantize_int8(target)
        g_hat[key] = dequantize_int8(codes, scales, g.shape)
        new_err[key] = target - g_hat[key]
    return g_hat, new_err


def init_error(params: dict) -> dict:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}

"""Training step: loss, grads, clipping, (optional) compression, AdamW.

Counterpart of ``repro.train.train_step``.  The JAX step is a pure
function of (params, opt_state, batch) that is jitted; here the state's
model is a :class:`~repro_torch.models.model.LanguageModel` with
gradients on, autograd takes the grads, and the update is written into
the model and the float32 moments in place (eager PyTorch, so every step
issues its own launches).  The JAX ``param_shardings`` pin the gradient
leaves to their parameters' layout on a mesh: on one device there is
nothing to pin, and the mesh side is ROADMAP item 14e.

A batch is the JAX one: ``tokens`` (B, S) int, or ``embeds`` (B, S, d)
where the config has ``embed_input=False``; ``labels`` (B, S) int, -1
ignored; ``image_embeds`` (B, T, d) for a cross-attention config.  numpy
arrays or tensors, moved to the model's device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LanguageModel
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.optimizer import OptConfig, OptState, true_div

AUX_LOSS_WEIGHT = 0.01
IGNORE = -1


class TrainState(NamedTuple):
    params: LanguageModel   # the trained model; its parameters are float32
    opt: OptState
    err: dict | None        # compression error feedback (or None)
    step: torch.Tensor      # 0-d int32


def train_state_for(model: LanguageModel, opt_cfg: OptConfig, *,
                    compress: bool = False) -> TrainState:
    """A fresh state around ``model``, whose gradients are turned on:
    zero moments (int8 as ``opt_cfg`` says, by the JAX tree's ranks), zero
    error feedback with ``compress``, step 0, all on the model's
    device."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = opt_lib.init_state(params, opt_cfg,
                             ranks=convert.jax_ranks(params))
    err = comp.init_error(params) if compress else None
    return TrainState(model, opt, err,
                      torch.zeros((), dtype=torch.int32,
                                  device=model.device))


def init_train_state(cfg: ModelConfig, opt_cfg: OptConfig, *, device=None,
                     seed: int = 0, compress: bool = False) -> TrainState:
    """The model of ``cfg`` with weights from a ``torch.Generator``
    seeded with ``seed`` (see ``LanguageModel``), and a fresh state, on
    ``cuda`` unless ``device`` names another (raises without a card)."""
    return train_state_for(LanguageModel(cfg, device=device, seed=seed),
                           opt_cfg, compress=compress)


def _on(x, dev, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=dtype)


def loss_fn(model: LanguageModel, cfg: ModelConfig, batch: dict):
    """Masked mean cross-entropy of the float32 log-softmax at the labels
    (clamped into the vocabulary for the gather; -1 masked), plus
    ``AUX_LOSS_WEIGHT`` times the MoE aux loss.  Returns (loss, (ce,
    aux))."""
    dev = model.device
    inputs = (_on(batch["tokens"], dev, torch.long) if cfg.embed_input
              else _on(batch["embeds"], dev))
    ctx = batch.get("image_embeds")
    logits, aux = model(inputs, None if ctx is None else _on(ctx, dev))
    labels = _on(batch["labels"], dev, torch.long)
    logp = torch.log_softmax(logits.float(), dim=-1)
    at = labels.clamp(0, logp.shape[-1] - 1)[..., None]
    take = torch.gather(logp, -1, at)[..., 0]
    mask = (labels != IGNORE).float()
    ce = -(take * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return ce + AUX_LOSS_WEIGHT * aux, (ce, aux)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, *,
                    compress: bool = False, microbatch: int = 0):
    """Returns ``train_step(state, batch) -> (state, metrics)``, metrics
    ``loss``, ``ce``, ``aux`` and ``grad_norm`` as 0-d tensors on the
    device (reading one waits for the step).

    ``microbatch > 0`` splits the batch into chunks of that many rows whose
    float32 grads are summed and then divided by their number, as the JAX
    ``lax.scan`` accumulates them: the compute / memory knob for large
    configs."""

    def grads_of(model, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if not microbatch:
            loss, (ce, aux) = loss_fn(model, cfg, batch)
            loss.backward()
            grads = {n: p.grad for n, p in params.items()}
            return loss.detach(), ce.detach(), aux.detach(), grads
        n_mb = len(batch["labels"]) // microbatch
        tot = None
        for i in range(n_mb):
            mb = {k: v[i * microbatch:(i + 1) * microbatch]
                  for k, v in batch.items()}
            loss, (ce, aux) = loss_fn(model, cfg, mb)
            loss.backward()                  # sums into .grad, float32
            part = torch.stack([loss, ce, aux]).detach()
            tot = part if tot is None else tot + part
        grads = {n: true_div(p.grad, n_mb) for n, p in params.items()}
        loss, ce, aux = true_div(tot, n_mb)
        return loss, ce, aux, grads

    def compressed(grads, err):
        """compress_with_feedback over the JAX tree's leaves: each block
        leaf's repeats concatenated (its flat blocks run across them),
        then split back."""
        groups = convert.leaf_groups(grads)
        cat = {key: torch.cat([grads[n].reshape(-1) for n in names])
               for key, names in groups.items()}
        ecat = {key: torch.cat([err[n].reshape(-1) for n in names])
                for key, names in groups.items()}
        g_hat, e_new = comp.compress_with_feedback(cat, ecat)
        out_g, out_e = {}, {}
        for key, names in groups.items():
            sizes = [grads[n].numel() for n in names]
            for n, g, e in zip(names, g_hat[key].split(sizes),
                               e_new[key].split(sizes)):
                out_g[n] = g.view(grads[n].shape)
                out_e[n] = e.view(grads[n].shape)
        return out_g, out_e

    def train_step(state: TrainState, batch: dict):
        model = state.params
        loss, ce, aux, grads = grads_of(model, batch)
        err = state.err
        if compress:
            grads, err = compressed(grads, err)
        params = dict(model.named_parameters())
        _, opt_state, gnorm = opt_lib.apply_updates(
            params, grads, state.opt, opt_cfg,
            ranks=convert.jax_ranks(params))
        for p in params.values():
            p.grad = None
        metrics = {"loss": loss, "ce": ce, "aux": aux, "grad_norm": gnorm}
        return TrainState(model, opt_state, err, state.step + 1), metrics

    return train_step

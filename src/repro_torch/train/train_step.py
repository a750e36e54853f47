"""Training step: loss, grads, clipping, (optional) compression, AdamW.

Counterpart of ``repro.train.train_step``.  The JAX step is a pure
function of (params, opt_state, batch) that is jitted; here the state's
model is a :class:`~repro_torch.models.model.LanguageModel` with
gradients on, autograd takes the grads, and the update is written into
the model and the float32 moments in place (eager PyTorch, so every step
issues its own launches).

On a mesh (``make_train_step(..., param_shardings=...)``, a state from
:func:`shard_state`) the step is ZeRO-3 storage with data-parallel
compute, and computes the function of the whole batch, as GSPMD does
for the JAX step:

  * the parameters, the moments (float32 or int8) and the error feedback
    are held as their blocks, placed by the JAX package's rules
    (``repro_torch.launch.sharding``), in a :class:`MeshParams`;
  * the batch is split over the data groups by the spec of the JAX
    embedding's constraint, ``spec_for(shape, "batch", "seq")`` (a
    group: one coordinate of the batch axes, ``pod`` x ``data``); a batch
    that does not divide is computed once, by the first group;
  * a config whose blocks are all ``attn`` (spadas_trajlm, llama3_8b,
    yi_9b, internlm2_20b, deepseek_coder_33b, musicgen_medium) computes
    each group's pass on the ``model`` axis as the JAX layers'
    annotations place it (``computes_on_model_axis``): each of the
    group's model coordinates holds its model block of each leaf,
    gathered over the data axes (``MeshParams.coord_model``), and
    computes its attention heads, its block of the SwiGLU ``d_ff`` and
    its vocabulary block of the embedding, the head and the CE
    (``models.layers``' ``*_tp`` pieces), and on its own copy the norms,
    the residual stream and any piece the axis does not divide; the
    partial products are all-reduced and k / v all-gathered, autograd
    runs across the coordinates from the loss at the group's lead, and
    the group's gradient is its blocks joined on the mesh lead, each
    replicated leaf's copies summed (``model_axis_grads``).  Its sums over the
    model axis are a new reduction order, so a data = 1 mesh is no
    longer bitwise the one-device step there;
  * any other config gathers the full parameters onto each group's lead
    device (its coordinate with the other axes at 0; the groups on one
    device share one gathered copy) and runs the group's forward and
    backward there, the ``model`` axis holding storage only (ROADMAP item
    14k);
  * each group's CE is the masked sum over its rows divided by the whole
    batch's label count;
  * the groups' gradients are summed in group order on the mesh's lead
    device; compression, where on, runs on that sum; the global norm is
    taken on it leaf by leaf, as on one device;
  * each coordinate runs the port's AdamW on its blocks.  An int8 moment
    is blocked in 256s along the last axis, so where a param block's last
    axis is not whole blocks, the moment's block and the param's differ:
    that leaf is updated in the moment's layout (each moment block with
    the param and gradient values it covers) and the param blocks take
    their new values from there.

The mesh step's pieces (``data_groups``, ``group_pass``,
``coord_update``) are module functions, so that the dry run
(``launch/specs.py``) runs them for the busiest coordinate alone.

The MoE aux loss is a product of whole-batch means, so MoE configs
raise where more than one group computes (ROADMAP item 14k).  Without
compute on the model axis, a data = 1 mesh runs the one-device step's
arithmetic op for op: it is bitwise equal to it.

A batch is the JAX one: ``tokens`` (B, S) int, or ``embeds`` (B, S, d)
where the config has ``embed_input=False``; ``labels`` (B, S) int, -1
ignored; ``image_embeds`` (B, T, d) for a cross-attention config.  numpy
arrays or tensors, moved to the model's device.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.core.distributed import (NamedSharding, PartitionSpec,
                                          Sharded, gather, gather_block,
                                          gather_tree, mesh_coords, place,
                                          place_tree, shard_slices,
                                          spec_axes, tree_bytes, write)
from repro_torch.launch.sharding import moment_sharding
from repro_torch.models import convert, sharding_rules
from repro_torch.models import layers as L
from repro_torch.models.config import (ATTN, ATTN_MOE, ATTN_MOE_DENSE,
                                       MAMBA_MOE, ModelConfig)
from repro_torch.models.model import LanguageModel
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.optimizer import (OptConfig, OptState, QTensor,
                                         true_div)

AUX_LOSS_WEIGHT = 0.01
IGNORE = -1


class TrainState(NamedTuple):
    params: LanguageModel   # the trained model (float32 or bf16), or
                            # MeshParams
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
                     seed: int = 0, compress: bool = False,
                     param_dtype: torch.dtype = torch.float32) -> TrainState:
    """The model of ``cfg`` with weights from a ``torch.Generator``
    seeded with ``seed`` (see ``LanguageModel``), its parameters in
    ``param_dtype`` (bf16 masters for the largest configs, as the JAX
    ``init_train_state(param_dtype=...)``; the moments and the error
    feedback stay float32 or int8), and a fresh state, on ``cuda`` unless
    ``device`` names another (raises without a card)."""
    return train_state_for(LanguageModel(cfg, device=device, seed=seed,
                                         param_dtype=param_dtype),
                           opt_cfg, compress=compress)


def _on(x, dev, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=dtype)


def loss_fn(model: LanguageModel, cfg: ModelConfig, batch: dict,
            denom: torch.Tensor | None = None, tp: L.ModelAxis | None = None):
    """Masked mean cross-entropy of the float32 log-softmax at the labels
    (clamped into the vocabulary for the gather; -1 masked), plus
    ``AUX_LOSS_WEIGHT`` times the MoE aux loss.  Returns (loss, (ce,
    aux)).  ``denom`` (a data group's rows on a mesh) replaces the label
    count of ``batch`` as the CE's divisor: the whole batch's, clamped at
    1.  ``tp`` computes the pass over the model axis
    (``LanguageModel.forward``); logits split over the vocabulary give
    the log-softmax at the labels from their blocks
    (``layers.vocab_parallel_logp``)."""
    dev = model.device
    inputs = (_on(batch["tokens"], dev, torch.long) if cfg.embed_input
              else _on(batch["embeds"], dev))
    ctx = batch.get("image_embeds")
    logits, aux = model(inputs, None if ctx is None else _on(ctx, dev),
                        tp=tp)
    labels = _on(batch["labels"], dev, torch.long)
    if isinstance(logits, L.VocabBlocks):
        take = L.vocab_parallel_logp(logits, labels)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        at = labels.clamp(0, logp.shape[-1] - 1)[..., None]
        take = torch.gather(logp, -1, at)[..., 0]
    mask = (labels != IGNORE).float()
    if denom is None:
        denom = torch.clamp_min(mask.sum(), 1.0)
    ce = -(take * mask).sum() / denom
    return ce + AUX_LOSS_WEIGHT * aux, (ce, aux)


def _compressed(grads: dict, err: dict):
    """compress_with_feedback over the JAX tree's leaves: each block
    leaf's repeats concatenated (its flat blocks run across them), then
    split back."""
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


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, *,
                    compress: bool = False, microbatch: int = 0,
                    param_shardings: dict | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``, metrics
    ``loss``, ``ce``, ``aux`` and ``grad_norm`` as 0-d tensors on the
    device (reading one waits for the step).

    ``microbatch > 0`` splits the batch into chunks of that many rows whose
    float32 grads are summed and then divided by their number, as the JAX
    ``lax.scan`` accumulates them: the compute / memory knob for large
    configs.

    ``param_shardings`` (param name -> NamedSharding, as
    ``launch.sharding.param_shardings`` gives them) makes it the mesh
    step, for a state placed by them (:func:`shard_state`): the data
    groups' whole gradients are summed at the mesh's lead, and each
    coordinate updates its blocks from that sum."""
    if param_shardings is not None:
        return _mesh_train_step(cfg, opt_cfg, compress, microbatch,
                                param_shardings)

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

    def train_step(state: TrainState, batch: dict):
        model = state.params
        loss, ce, aux, grads = grads_of(model, batch)
        err = state.err
        if compress:
            grads, err = _compressed(grads, err)
        params = dict(model.named_parameters())
        _, opt_state, gnorm = opt_lib.apply_updates(
            params, grads, state.opt, opt_cfg,
            ranks=convert.jax_ranks(params))
        for p in params.values():
            p.grad = None
        metrics = {"loss": loss, "ce": ce, "aux": aux, "grad_norm": gnorm}
        return TrainState(model, opt_state, err, state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# the train state on a mesh
# ---------------------------------------------------------------------------

MOE_KINDS = (ATTN_MOE, ATTN_MOE_DENSE, MAMBA_MOE)
MODEL_AXIS = "model"


def computes_on_model_axis(cfg: ModelConfig, mesh) -> bool:
    """Whether the mesh step splits a data group's pass over the
    ``model`` axis: a config whose blocks are all ``attn``, on a mesh
    whose model axis is larger than 1.  Other configs compute the whole
    model at each group's lead (ROADMAP item 14k)."""
    return (mesh.shape.get(MODEL_AXIS, 1) > 1
            and all(k == ATTN for k in cfg.block_pattern))


def model_block(shape, sharding: NamedSharding, coord: dict) -> tuple:
    """The slices of a leaf of ``shape`` that coordinate ``coord``
    computes on: its block under ``sharding`` split over the model axis
    alone (the data axes' blocks gathered, ZeRO-3)."""
    spec = PartitionSpec(*(MODEL_AXIS if MODEL_AXIS in spec_axes(e)
                           else None for e in sharding.spec))
    return shard_slices(shape, NamedSharding(sharding.mesh, spec), coord)


def model_coords(mesh, lead: int) -> list:
    """The coordinate indices (``mesh.flat`` order) of the model axis
    through coordinate ``lead``, in model order."""
    coords = mesh_coords(mesh)
    c0 = coords[lead]
    on = [(c[MODEL_AXIS], i) for i, c in enumerate(coords)
          if all(v == c0[a] for a, v in c.items() if a != MODEL_AXIS)]
    return [i for _, i in sorted(on)]


def blocks_model(cfg: ModelConfig, blocks: dict, device) -> LanguageModel:
    """A work model of ``cfg`` whose parameters are empty tensors of the
    shapes and dtypes ``blocks`` (name -> (shape, dtype)) gives, on
    ``device``, with gradients on."""
    model = LanguageModel(cfg, device="meta")
    for n, (shape, dtype) in blocks.items():
        owner, leaf = n.rsplit(".", 1)
        setattr(model.get_submodule(owner), leaf, nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device)))
    return model


def model_axis_grads(models: list, tensors: dict, coords: list,
                     device) -> dict:
    """A data group's gradients after its pass over the model axis, whole
    on ``device``: a split leaf's blocks (``models[m]``, at ``coords[m]``)
    joined; a replicated leaf's copies' gradients summed in coordinate
    order (each copy holds the part that flowed through its coordinate;
    a copy no path reached has none).  Fewer models than coordinates (the
    dry run's stand-in) leave the missing blocks empty."""
    named = [dict(m.named_parameters()) for m in models]
    out = {}
    for n, x in tensors.items():
        gs = [nm[n].grad for nm in named]
        if tuple(gs[0].shape) == tuple(x.shape):
            acc = None
            for g in gs:
                if g is not None:
                    acc = g.to(device) if acc is None else acc + g.to(device)
            out[n] = acc
            continue
        whole = torch.empty(x.shape, dtype=gs[0].dtype, device=device)
        for g, c in zip(gs, coords):
            whole[model_block(x.shape, x.sharding, c)] = g
        out[n] = whole
    return out


class MeshParams:
    """A model's parameters held on a mesh as their blocks (ZeRO-3
    storage), and the work models the data groups compute on.

    ``tensors`` maps each parameter name (the model's, in its order) to a
    ``Sharded`` array placed by ``shardings``.  ``gathered(device)``
    writes the whole parameters into that device's work model: one per
    distinct device (the coordinates of ``["cuda:0"] * 8`` share one),
    the first being the model the state was made from.
    ``coord_model(i)`` is coordinate i's work model for compute on the
    model axis: its own, holding its model blocks."""

    def __init__(self, model: LanguageModel, shardings: dict):
        named = dict(model.named_parameters())
        if set(named) != set(shardings):
            raise ValueError(f"shardings name {sorted(set(shardings))[:4]}"
                             f"..., the model {sorted(named)[:4]}...")
        self.cfg = model.cfg
        self.shardings = {n: shardings[n] for n in named}
        self.mesh = next(iter(shardings.values())).mesh
        self.tensors = {n: place(p.detach(), self.shardings[n])
                        for n, p in named.items()}
        model.requires_grad_(True)
        self._work = {self.mesh.lead: model.to(self.mesh.lead)}
        self._coords = mesh_coords(self.mesh)
        self._blocks = {}           # coordinate index -> its work model

    def work_model(self, device) -> LanguageModel:
        """The work model on ``device`` (made by copying another)."""
        dev = torch.device(device)
        if dev not in self._work:
            self._work[dev] = copy.deepcopy(
                next(iter(self._work.values()))).to(dev)
        return self._work[dev]

    @torch.no_grad()
    def coord_model(self, i: int) -> LanguageModel:
        """Coordinate ``i``'s work model holding its model block of each
        leaf (``model_block``: gathered over the data axes from the
        blocks of the data coordinates that share its model index; a leaf
        the model axis does not split, whole), on its device."""
        c = self._coords[i]
        if i not in self._blocks:
            self._blocks[i] = blocks_model(self.cfg, {
                n: (tuple(s.stop - s.start for s in model_block(
                    x.shape, x.sharding, c)), x.shards[0].dtype)
                for n, x in self.tensors.items()}, self.mesh.flat[i])
        model = self._blocks[i]
        for n, p in model.named_parameters():
            x = self.tensors[n]
            gather_block(x, model_block(x.shape, x.sharding, c), p)
        return model

    @torch.no_grad()
    def gathered(self, device) -> LanguageModel:
        """The work model on ``device`` holding the whole parameters."""
        model = self.work_model(device)
        for n, p in model.named_parameters():
            gather(self.tensors[n], out=p)
        return model


def _state_shardings(tree: dict, shardings: dict) -> dict:
    """The shardings of a moment or error tree that mirrors params placed
    by ``shardings``."""
    return {n: moment_sharding(shardings[n], x) if isinstance(x, QTensor)
            else shardings[n] for n, x in tree.items()}


def shard_state(state: TrainState, shardings: dict) -> TrainState:
    """A one-device state placed on a mesh by ``shardings`` (param name ->
    NamedSharding): the params by them, the float32 moments and the error
    feedback alike, int8 moments by ``moment_sharding``; ``count`` and
    ``step`` on the mesh's lead device.  The state's model becomes the
    lead device's work model (moved there)."""
    params = MeshParams(state.params, shardings)
    lead = params.mesh.lead

    def placed(tree):
        return place_tree(tree, _state_shardings(tree, shardings))

    err = None if state.err is None else placed(state.err)
    return TrainState(params, OptState(placed(state.opt.m),
                                       placed(state.opt.v),
                                       state.opt.count.to(lead)),
                      err, state.step.to(lead))


def unshard_state(state: TrainState, device=None) -> TrainState:
    """A mesh state gathered onto one device (the mesh's lead device by
    default), as a one-device state of its own (a copy of the work
    model there, holding the parameters)."""
    params = state.params
    dev = torch.device(device) if device is not None else params.mesh.lead
    model = copy.deepcopy(params.gathered(dev))

    def whole(tree):
        return None if tree is None else gather_tree(tree, dev)

    return TrainState(model, OptState(whole(state.opt.m),
                                      whole(state.opt.v),
                                      state.opt.count.to(dev)),
                      whole(state.err), state.step.to(dev))


def reshard_state(state: TrainState, shardings: dict) -> TrainState:
    """The state (on one device or on a mesh) placed by ``shardings``,
    on their mesh."""
    if convert.on_mesh(state):
        state = unshard_state(state, next(iter(shardings.values())).mesh.lead)
    return shard_state(state, shardings)


def state_device_bytes(state: TrainState) -> list:
    """Resident bytes of each mesh coordinate (``mesh.flat`` order): its
    blocks of the params, the moments and the error feedback."""
    trees = [state.params.tensors, state.opt.m, state.opt.v]
    return tree_bytes(*trees, *([state.err] if state.err is not None
                                else []))


def _group_lead_coords(mesh, axes) -> list:
    """The coordinate index (``mesh.flat`` order) of each data group's
    lead: the coordinates of ``axes`` (the batch's split, major first) in
    batch order, each with every other axis at 0."""
    sizes = mesh.shape
    leads = []
    for i, c in enumerate(mesh_coords(mesh)):
        if all(v == 0 for a, v in c.items() if a not in axes):
            pos = 0
            for a in axes:
                pos = pos * sizes[a] + c[a]
            leads.append((pos, i))
    return [i for _, i in sorted(leads)]


def data_groups(mesh, labels_shape, microbatch: int = 0) -> tuple:
    """How the mesh step splits a batch whose labels have
    ``labels_shape``: (the coordinate index of each data group's lead, in
    batch order; the rows each group computes of a microbatch).  The split
    is the spec of the JAX embedding's constraint on a microbatch; a
    batch that does not divide is one group's."""
    size = microbatch or labels_shape[0]
    spec = sharding_rules.spec_for((size,) + tuple(labels_shape[1:]),
                                   "batch", "seq", mesh=mesh)
    leads = _group_lead_coords(mesh, spec_axes(spec[0]))
    return leads, size // len(leads)


def _moment_region(x: Sharded, m: QTensor, coord: dict, block: int
                   ) -> tuple:
    """The param elements the int8 moment block of coordinate ``coord``
    covers: its lead dims' slices and, on the last axis, its blocks'
    columns (the last block cut at the param's extent)."""
    idx = shard_slices(m.codes.shape, m.codes.sharding, coord)
    b = idx[-2]
    return idx[:-2] + (slice(b.start * block,
                             min(b.stop * block, x.shape[-1])),)


def group_pass(model: LanguageModel, cfg, batch: dict, g: int, rows: int,
               size: int, denoms: list, tp: L.ModelAxis | None = None
               ) -> list:
    """Data group ``g``'s forward and backward on its ``rows`` rows of
    each microbatch (``size`` rows a microbatch, one CE divisor each in
    ``denoms``), its gradients summed into the model's ``.grad`` (with
    ``tp``, into each model coordinate's work model, ``model`` being
    ``tp.models[0]``).  Returns each microbatch's (loss, ce, aux),
    stacked, on the model's device."""
    for m in ([model] if tp is None else tp.models):
        for p in m.parameters():
            p.grad = None
    out = []
    for i, denom in enumerate(denoms):
        lo = i * size + g * rows
        part = {k: v[lo:lo + rows] for k, v in batch.items()}
        loss, (ce, aux) = loss_fn(model, cfg, part, denom.to(model.device),
                                  tp=tp)
        loss.backward()                      # sums into .grad
        out.append(torch.stack([loss, ce, aux]).detach())
    return out


def ce_divisors(labels, size: int, device) -> list:
    """Each microbatch's CE divisor on ``device`` (``size`` rows a
    microbatch): its labels that count, at least 1.  Every group divides
    its CE sum by its microbatch's, so the groups' parts add up to the
    whole microbatch's mean."""
    out = []
    for i in range(len(labels) // size):
        lab = _on(labels[i * size:(i + 1) * size], device, torch.long)
        out.append(torch.clamp_min((lab != IGNORE).float().sum(), 1.0))
    return out


def finish_grads(total: dict, n_mb: int | None, err: dict | None) -> tuple:
    """The mesh step's gradients after the groups' sum, on the lead:
    divided by the number of microbatches ``n_mb`` (None: the step does
    not microbatch), compressed with error feedback where ``err`` (the
    whole error tensors) is given, and the global norm of what AdamW then
    takes, as the one-device step takes it.  Returns (grads, the new
    whole error or None, the norm)."""
    order = list(total)
    if n_mb is not None:
        total = {n: true_div(g, n_mb) for n, g in total.items()}
    e_new = None
    if err is not None:
        total, e_new = _compressed(total, err)
    return total, e_new, opt_lib.global_norm(total[n] for n in order)


def misaligned(tensors: dict, opt_m: dict, block: int) -> set:
    """The leaves whose int8 moment blocks do not line up with their
    param blocks at some coordinate: ``coord_update`` updates them in the
    moment's layout, from the whole params."""
    out = set()
    for n, x in tensors.items():
        m = opt_m[n]
        if isinstance(m, QTensor) and any(
                _moment_region(x, m, c, block)
                != shard_slices(x.shape, x.sharding, c)
                for c in mesh_coords(x.sharding.mesh)):
            out.add(n)
    return out


@torch.no_grad()
def coord_update(tensors: dict, grads: dict, opt: OptState, gn, wparams:
                 dict, ranks: dict, opt_cfg: OptConfig, i: int, c: dict,
                 dev, updated: dict) -> tuple:
    """Coordinate ``i`` (at ``c``, on ``dev``) of the mesh step's AdamW on
    its blocks of ``tensors`` (name -> Sharded params), from the whole
    summed ``grads`` and the whole params ``wparams`` on the lead device.
    A leaf whose int8 moment blocks do not line up with its param blocks
    is updated in the moment's layout: the new values of the region this
    coordinate's moment block covers are written into ``updated[name]``
    (a whole tensor, made at the first such region).  Returns (name -> its
    new m part, name -> its new v part)."""
    p_c, g_c, m_c, v_c = {}, {}, {}, {}
    new_m, new_v = {}, {}
    count, gn_c = opt.count.to(dev), gn.to(dev)
    for n, x in tensors.items():
        idx = shard_slices(x.shape, x.sharding, c)
        m, v = opt.m[n], opt.v[n]
        if not isinstance(m, QTensor):
            p_c[n], g_c[n] = x.shards[i], grads[n][idx].to(dev)
            m_c[n], v_c[n] = m.shards[i], v.shards[i]
            continue
        region = _moment_region(x, m, c, opt_cfg.q_block)
        shape = tuple(s.stop - s.start for s in region)
        mq = QTensor(m.codes.shards[i], m.scales.shards[i], shape)
        vq = QTensor(v.codes.shards[i], v.scales.shards[i], shape)
        if region == idx:
            p_c[n], g_c[n] = x.shards[i], grads[n][idx].to(dev)
            m_c[n], v_c[n] = mq, vq
            continue
        p_r = wparams[n][region].to(dev, copy=True)
        _, st, _ = opt_lib.apply_updates(
            {n: p_r}, {n: grads[n][region].to(dev)},
            OptState({n: mq}, {n: vq}, count), opt_cfg,
            ranks={n: ranks[n]}, grad_norm=gn_c)
        if n not in updated:
            updated[n] = torch.empty_like(wparams[n])
        updated[n][region] = p_r.to(updated[n].device)
        new_m[n], new_v[n] = st.m[n], st.v[n]
    _, st, _ = opt_lib.apply_updates(
        p_c, g_c, OptState(m_c, v_c, count), opt_cfg, ranks=ranks,
        grad_norm=gn_c)
    for n in p_c:
        new_m[n], new_v[n] = st.m[n], st.v[n]
    return new_m, new_v


def _mesh_train_step(cfg, opt_cfg, compress, microbatch, param_shardings):
    moe = any(k in MOE_KINDS for k in cfg.block_pattern)
    tp = computes_on_model_axis(
        cfg, next(iter(param_shardings.values())).mesh)

    mis = []                        # the misaligned int8 leaves, once

    def grads_of(params: MeshParams, batch: dict, opt_m: dict):
        """The whole batch's loss parts and summed gradients (whole, on
        the mesh's lead device), and the whole params ``update`` reads."""
        mesh = params.mesh
        lead = mesh.lead
        n_rows = len(batch["labels"])
        size = microbatch or n_rows
        n_mb = n_rows // size
        coords, rows = data_groups(mesh, batch["labels"].shape, microbatch)
        leads = [mesh.flat[i] for i in coords]
        if moe and len(leads) > 1:
            raise NotImplementedError(
                f"{cfg.name}: the MoE aux loss is a product of whole-batch "
                f"means, so an MoE config trains on a mesh with one data "
                f"group computing (ROADMAP item 14k); this batch splits "
                f"over {len(leads)}")
        denoms = ce_divisors(batch["labels"], size, lead)
        models, parts, total = {}, [[] for _ in range(n_mb)], None
        all_coords = mesh_coords(mesh)
        for g, dev in enumerate(leads):
            if tp:                  # the group's model axis computes
                idx = model_coords(mesh, coords[g])
                work = [params.coord_model(i) for i in idx]
                ax = L.ModelAxis(work)
            else:                   # the group's lead computes it whole
                if dev not in models:
                    models[dev] = params.gathered(dev)
                work, ax = [models[dev]], None
            for i, part in enumerate(group_pass(work[0], cfg, batch, g,
                                                rows, size, denoms, tp=ax)):
                parts[i].append(part.to(lead))
            if tp:
                grads = model_axis_grads(work, params.tensors,
                                         [all_coords[i] for i in idx], lead)
            else:
                grads = {n: p.grad.to(lead)
                         for n, p in work[0].named_parameters()}
            for m in work:
                for p in m.parameters():
                    p.grad = None
            total = grads if total is None else {
                n: total[n] + grads[n] for n in total}
            del grads       # not held through the next group's pass
        tot = None
        for i in range(n_mb):
            part = parts[i][0]
            for more in parts[i][1:]:
                part = part + more
            tot = part if tot is None else tot + part
        if microbatch:
            tot = true_div(tot, n_mb)
        loss, ce, aux = tot
        if tp:                      # whole params only where AdamW reads them
            if not mis:
                mis.append(misaligned(params.tensors, opt_m,
                                      opt_cfg.q_block))
            wparams = {n: gather(x) if n in mis[0] else x.shards[0]
                       for n, x in params.tensors.items()}
        else:
            wparams = dict(models[lead].named_parameters())
        return loss, ce, aux, total, wparams

    @torch.no_grad()
    def update(params: MeshParams, grads: dict, opt: OptState, gn,
               wparams: dict) -> OptState:
        """Each coordinate's AdamW on its blocks (``coord_update``), then
        the misaligned int8 leaves' new values written to every block.
        ``wparams``: the whole params before the update, on the lead, of
        every leaf ``coord_update`` reads whole."""
        mesh = params.mesh
        ranks = convert.jax_ranks(wparams)
        new = {"m": {n: [] for n in params.tensors},
               "v": {n: [] for n in params.tensors}}
        updated = {}            # misaligned leaf -> its new whole values
        for i, (c, dev) in enumerate(zip(mesh_coords(mesh), mesh.flat)):
            new_m, new_v = coord_update(params.tensors, grads, opt, gn,
                                        wparams, ranks, opt_cfg, i, c, dev,
                                        updated)
            for n in params.tensors:
                new["m"][n].append(new_m[n])
                new["v"][n].append(new_v[n])
        for n, whole_n in updated.items():
            write(params.tensors[n], whole_n)

        def rebuilt(tree, which):
            out = {}
            for n, x in tree.items():
                parts = new[which][n]
                if isinstance(x, QTensor):
                    out[n] = QTensor(
                        Sharded([q.codes for q in parts], x.codes.sharding,
                                x.codes.shape),
                        Sharded([q.scales for q in parts], x.scales.sharding,
                                x.scales.shape), x.shape)
                else:
                    out[n] = Sharded(parts, x.sharding, x.shape)
            return out

        return OptState(rebuilt(opt.m, "m"), rebuilt(opt.v, "v"),
                        opt.count + 1)

    def train_step(state: TrainState, batch: dict):
        params = state.params
        if (not isinstance(params, MeshParams)
                or params.shardings != {n: param_shardings[n]
                                        for n in params.tensors}):
            raise ValueError("the mesh step takes a state placed by its "
                             "param_shardings (shard_state)")
        loss, ce, aux, grads, wparams = grads_of(params, batch,
                                                 state.opt.m)
        err = state.err
        n_mb = len(batch["labels"]) // microbatch if microbatch else None
        grads, e_new, gn = finish_grads(
            grads, n_mb, gather_tree(err) if compress else None)
        if compress:
            for n, x in err.items():
                write(x, e_new[n])
        opt = update(params, grads, state.opt, gn, wparams)
        metrics = {"loss": loss, "ce": ce, "aux": aux, "grad_norm": gn}
        return TrainState(params, opt, err, state.step + 1), metrics

    return train_step

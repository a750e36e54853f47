"""Cell definitions: (architecture x input shape) -> the port's inputs on
``meta``, their placement on a mesh, and the work of the coordinate that
the port's code makes busiest.

Counterpart of ``repro.launch.specs``: the same 40-cell grid (10 archs x
{train_4k, prefill_32k, decode_32k, long_500k}; long_500k only for the
sub-quadratic archs, the other 8 a documented skip), the same logical
rules (``arch_rules``), dtypes (bf16 params and int8 moments above 60e9
parameters) and placements (``launch.sharding``).  Where the JAX plan
hands XLA a function and the shardings of its abstract inputs, a port
plan holds:

  * ``abstract_args``: every input leaf of the step as a meta tensor of
    its JAX shape and dtype, whole, by name (``params/<name>``,
    ``opt.m/<name>`` (``.codes`` / ``.scales`` for int8), ``err/...``,
    ``batch/...``, ``caches/<position>/<key>``, ``count``, ``step``);
  * ``in_shardings``: each leaf's ``NamedSharding``, or None for a 0-d
    leaf the port keeps on the mesh's lead device alone;
  * ``step_fn``: what the mesh's lead (coordinate 0, the busiest) does in
    one step, on meta tensors standing for what it holds (its blocks),
    through the port's own code:
      - train on one device: the port's one-device step;
      - train on a mesh: the mesh step's pieces at the lead
        (``train_step``): the gather of its work model, its data group's
        forward and backward (``group_pass``), the sum of the other
        groups' gradients as they arrive, the global norm, the
        compression where on, and its AdamW on its blocks
        (``coord_update``).  A config whose blocks are all ``attn``
        computes on the model axis: the lead gathers its model blocks and
        computes its part of the group's pass, the other coordinates'
        results arriving as stand-ins (``LeadAxis``, which books the
        moves); other configs gather the whole params at the lead, the
        ``model`` axis storage only (14k);
      - prefill and decode: the port serves the LM on one device, so on a
        mesh the lead gathers the whole params (and caches), computes,
        and keeps its block of the caches;
  * ``moves``: the bytes the port moves between coordinates, booked at
    the coordinate that receives them under the JAX collective that does
    the same job (``dryrun.book``).  0-d tensors (loss parts, CE
    divisors, the gradient norm, the step count) are not booked.

``make_plan`` sets the global logical rules and mesh
(``models.sharding_rules``), as the JAX module does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import configs
from repro_torch.core.distributed import (Mesh, NamedSharding, Sharded,
                                          gather, gather_block, mesh_coords,
                                          shard_slices, spec_axes)
from repro_torch.launch import sharding as sh
from repro_torch.models import convert, sharding_rules
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LanguageModel
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import OptState, QTensor

#: where a plan's tensors live, whatever devices its mesh lists: a mesh's
#: devices only name its coordinates here
META = torch.device("meta")

# shape_name -> (kind, global_batch, seq_len)
SHAPES: dict[str, tuple[str, int, int]] = {
    "train_4k":    ("train",   256, 4_096),
    "prefill_32k": ("prefill",  32, 32_768),
    "decode_32k":  ("decode",  128, 32_768),
    "long_500k":   ("decode",    1, 524_288),
}

SKIP_REASON = ("full-attention arch: 512k-token decode requires a "
               "sub-quadratic mechanism per the assignment; skipped "
               "(see DESIGN.md sec. 5)")


def runnable(cfg: ModelConfig, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return cfg.sub_quadratic
    return True


def all_cells(include_skips: bool = False):
    """Yield (arch, shape_name) for the 40-cell grid (the paper-native
    config is extra and not part of the assigned grid)."""
    for arch in configs.ARCH_IDS:
        if arch == "spadas_trajlm":
            continue
        cfg = configs.get(arch)
        for shape_name in SHAPES:
            if runnable(cfg, shape_name) or include_skips:
                yield arch, shape_name


def arch_rules(cfg: ModelConfig, kind: str) -> dict:
    """Logical-rule overrides for a given (arch, step kind)."""
    rules = {}
    if cfg.n_experts and cfg.n_experts % 16 == 0:
        rules["expert"] = "model"      # EP when experts divide the TP axis
    if kind in ("prefill", "decode"):
        rules["kvseq"] = "model"       # shard cache time on long contexts
        rules["no_fsdp"] = True        # serving keeps params TP-resident
    return rules


def _param_dtype(cfg: ModelConfig) -> torch.dtype:
    # giant archs: bf16 params + int8 moments
    return torch.bfloat16 if cfg.param_count() > 60e9 else torch.float32


def _opt_cfg(cfg: ModelConfig) -> opt_lib.OptConfig:
    int8 = cfg.param_count() > 60e9
    return opt_lib.OptConfig(state_dtype="int8" if int8 else "fp32")


def abstract_params(cfg: ModelConfig) -> LanguageModel:
    """The model of ``cfg`` on ``meta``, its params in the plan's dtype."""
    return LanguageModel(cfg, device="meta", param_dtype=_param_dtype(cfg))


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _batch_specs(cfg: ModelConfig, B: int, S: int, *,
                 with_labels: bool) -> dict:
    batch = {}
    if cfg.embed_input:
        batch["tokens"] = _meta((B, S), torch.int32)
    else:
        batch["embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16)
    if cfg.vision_tokens:
        batch["image_embeds"] = _meta((B, cfg.vision_tokens, cfg.d_model),
                                      torch.bfloat16)
    if with_labels:
        batch["labels"] = _meta((B, S), torch.int32)
    return batch


def _batch_shardings(batch: dict, mesh: Mesh) -> dict:
    return {k: NamedSharding(mesh, sh.spec_for_batch_leaf(v.shape, mesh))
            for k, v in batch.items()}


def _inputs(batch: dict) -> tuple:
    """(model inputs, cross-attention context or None) of a batch."""
    x = batch["tokens"] if "tokens" in batch else batch["embeds"]
    return x, batch.get("image_embeds")


@dataclasses.dataclass
class LoweringPlan:
    """Everything dryrun.py needs for one cell (see the module doc)."""
    name: str
    kind: str
    mesh: Mesh
    step_fn: Callable
    abstract_args: dict
    in_shardings: dict
    moves: list = dataclasses.field(default_factory=list)
    work_bytes: int = 0          # the params the lead keeps to compute on
    compute: dict = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# blocks and moves
# ---------------------------------------------------------------------------


class LeadAxis(L.ModelAxis):
    """The model axis of the plan's busiest coordinate: coordinate 0 of
    ``size`` computes alone (``model`` its work model).  Each collective
    takes its one input, adds the other coordinates' as stand-ins (empty
    tensors of its shape) and books in ``moves`` what coordinate 0
    receives, as (JAX collective, bytes, moved bytes); the gradient's
    collective when the backward pass reaches it.  A forward recomputed
    in the backward pass (remat) books its moves again."""

    def __init__(self, model: LanguageModel, size: int):
        super().__init__([model])
        self.extent = size
        self.moves = []

    @property
    def size(self) -> int:
        return self.extent

    def _book(self, out, op: str, nbytes: int, back: str | None):
        moved = (self.extent - 1) * nbytes
        self.moves.append((op, _nbytes(out), moved))
        if back is not None and out.requires_grad:
            out.register_hook(lambda g: self.moves.append(
                (back, _nbytes(g), moved)))
        return [out]

    def _others(self, y) -> list:
        return [torch.empty_like(y) for _ in range(self.extent - 1)]

    def all_reduce(self, ys, dtype):
        acc = ys[0].float()
        for o in self._others(acc):
            acc = acc + o
        return self._book(acc.to(dtype), "all-reduce", _nbytes(ys[0]),
                          "all-reduce")

    def all_gather(self, ys, dim=-1):
        return self._book(torch.cat(ys + self._others(ys[0]), dim=dim),
                          "all-gather", _nbytes(ys[0]), "reduce-scatter")

    def all_max(self, ys):
        return self._book(torch.stack(ys + self._others(ys[0])).amax(0),
                          "all-reduce", _nbytes(ys[0]), None)


def _split(sharding: NamedSharding | None) -> int:
    """Into how many blocks ``sharding`` cuts a leaf (its spec's axes)."""
    if sharding is None:
        return 1
    sizes = sharding.mesh.shape
    return math.prod(sizes[a] for e in sharding.spec for a in spec_axes(e))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def block_bytes(t: torch.Tensor, sharding: NamedSharding | None,
                n_coords: int) -> list:
    """The bytes of ``t``'s block at each coordinate (``mesh.flat``
    order), from ``shard_slices``; a leaf without a sharding lives on the
    lead alone."""
    if sharding is None:
        return [_nbytes(t)] + [0] * (n_coords - 1)
    out = []
    for c in mesh_coords(sharding.mesh):
        idx = shard_slices(t.shape, sharding, c)
        out.append(math.prod(s.stop - s.start for s in idx)
                   * t.element_size())
    return out


def _extent(idx: tuple) -> tuple:
    return tuple(s.stop - s.start for s in idx)


def _block(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """A meta tensor of ``t``'s block shape under ``sharding``."""
    idx = shard_slices(t.shape, sharding, mesh_coords(sharding.mesh)[0])
    return _meta(tuple(s.stop - s.start for s in idx), t.dtype)


def _sharded(t: torch.Tensor, sharding: NamedSharding) -> Sharded:
    """``t`` placed by ``sharding`` on meta, one block tensor standing
    for every coordinate's (the blocks are equal in shape)."""
    blk = _block(t, sharding)
    return Sharded([blk] * len(sharding.mesh.flat), sharding,
                   tuple(t.shape))


def _gathers(at: int, leaves: dict, shardings: dict, n: int) -> list:
    """The lead-side all-gather of whole ``leaves`` at coordinate ``at``:
    each split leaf's bytes not held there."""
    out = []
    for name, t in leaves.items():
        s = shardings[name]
        if _split(s) > 1:
            own = block_bytes(t, s, n)[at]
            out.append((at, "all-gather", _nbytes(t), _nbytes(t) - own))
    return out


def _scatters(leaves: dict, shardings: dict, n: int,
              op: str = "collective-permute") -> list:
    """Each non-lead coordinate receiving its block of ``leaves`` from
    the lead."""
    out = []
    for name, t in leaves.items():
        for c, b in enumerate(block_bytes(t, shardings[name], n)):
            if c and b:
                out.append((c, op, b, b))
    return out


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _flat_state(params: dict, opt: OptState, err, p_shard: dict,
                m_shard: dict) -> tuple:
    """(name -> meta leaf, name -> sharding) of a train state."""
    args, shards = {}, {}
    for n, p in params.items():
        args[f"params/{n}"], shards[f"params/{n}"] = p, p_shard[n]
    trees = [("opt.m", opt.m), ("opt.v", opt.v)] + (
        [("err", err)] if err is not None else [])
    for prefix, tree in trees:
        for n, x in tree.items():
            s = m_shard[n] if prefix != "err" else p_shard[n]
            if isinstance(x, QTensor):
                args[f"{prefix}/{n}.codes"] = x.codes
                args[f"{prefix}/{n}.scales"] = x.scales
                shards[f"{prefix}/{n}.codes"] = s.codes
                shards[f"{prefix}/{n}.scales"] = s.scales
            else:
                args[f"{prefix}/{n}"], shards[f"{prefix}/{n}"] = x, s
    for n in ("count", "step"):
        args[n], shards[n] = _meta((), torch.int32), None
    return args, shards


def _train_plan(cfg, name, mesh, B, S, rules, compress, microbatch):
    opt_cfg = _opt_cfg(cfg)
    model = abstract_params(cfg)
    state = ts.train_state_for(model, opt_cfg, compress=compress)
    params = dict(model.named_parameters())
    p_shard = sh.param_shardings(params, mesh, rules)
    m_shard = ts._state_shardings(state.opt.m, p_shard)
    args, shards = _flat_state(params, state.opt, state.err, p_shard,
                               m_shard)
    batch = _batch_specs(cfg, B, S, with_labels=True)
    b_shard = _batch_shardings(batch, mesh)
    for k, v in batch.items():
        args[f"batch/{k}"], shards[f"batch/{k}"] = v, b_shard[k]
    n = len(mesh.flat)
    if n == 1:
        step = ts.make_train_step(cfg, opt_cfg, compress=compress,
                                  microbatch=microbatch)

        def one_step():
            st, met = step(state, batch)
            return (dict(st.params.named_parameters()), st.opt, st.err,
                    st.step, met)

        return LoweringPlan(
            name, "train", mesh, one_step, args, shards,
            compute={"placement": "one device: the port's one-device step",
                     "groups": 1, "rows_per_group": B,
                     "counted": "the whole step"})
    coords, rows = ts.data_groups(mesh, (B, S), microbatch)
    moe = any(k in ts.MOE_KINDS for k in cfg.block_pattern)
    tp = ts.computes_on_model_axis(cfg, mesh)
    note = ("data groups over their model coordinates: attention heads, "
            "the SwiGLU d_ff and the vocabulary of the embedding, head and "
            "CE split over the model axis, the replicated activations and "
            "a piece it does not divide on every coordinate (configs whose "
            "blocks are all attn)"
            if tp else "data groups at their leads, the model axis storage "
            "only (ROADMAP 14k: configs with other block kinds)")
    if moe and len(coords) > 1:
        # the port's mesh step raises here (the aux loss needs whole-batch
        # means, 14k); counted as the one group it allows
        coords, rows = coords[:1], microbatch or B
        note = ("one data group: the port's mesh step raises for an MoE "
                "config whose batch splits (ROADMAP 14k); counted as the "
                "whole batch at the lead")
    G = len(coords)
    size = microbatch or B
    n_mb = B // size
    lead = mesh_coords(mesh)[0]

    # the lead's blocks (what it holds), and the whole params' sources
    blocks = {k: _sharded(v, shards[k]) if shards[k] is not None else v
              for k, v in args.items() if not k.startswith("batch/")}
    tensors = {pn: blocks[f"params/{pn}"] for pn in params}

    def moments(prefix):
        out = {}
        for pn, x in getattr(state.opt, prefix[-1]).items():
            if isinstance(x, QTensor):
                out[pn] = QTensor(blocks[f"{prefix}/{pn}.codes"],
                                  blocks[f"{prefix}/{pn}.scales"], x.shape)
            else:
                out[pn] = blocks[f"{prefix}/{pn}"]
        return out

    opt_in = OptState(moments("opt.m"), moments("opt.v"), blocks["count"])
    all_coords = mesh_coords(mesh)
    read_whole = ts.misaligned(tensors, opt_in.m, opt_cfg.q_block)
    if tp:
        M = mesh.shape[ts.MODEL_AXIS]
        axes = {c: ts.model_coords(mesh, c) for c in coords}
        axis0 = axes[coords[0]]                  # group 0's coordinates
        mblock = {pn: _extent(ts.model_block(p.shape, p_shard[pn],
                                             all_coords[0]))
                  for pn, p in params.items()}   # equal at every coordinate
        work = ts.blocks_model(cfg, {            # MeshParams.coord_model
            pn: (mblock[pn], p.dtype) for pn, p in params.items()}, META)
        wparams = {pn: _meta(p.shape, p.dtype) if pn in read_whole
                   else tensors[pn].shards[0] for pn, p in params.items()}
    else:
        work = abstract_params(cfg)
        work.requires_grad_(True)
        wparams = dict(work.named_parameters())
    ranks = convert.jax_ranks(wparams)
    moves = []                                   # booked below and by tp

    def group_grads():
        """Group 0's pass and its gradients, whole; with tp the lead's
        part, the others' results stand-ins, its moves booked for every
        coordinate (each does the same collectives)."""
        denoms = ts.ce_divisors(batch["labels"], size, META)
        if not tp:
            for pn, p in wparams.items():        # MeshParams.gathered
                gather(tensors[pn], out=p.data)
            parts = ts.group_pass(work, cfg, batch, 0, rows, size, denoms)
            total = {pn: p.grad for pn, p in wparams.items()}
            for p in wparams.values():
                p.grad = None
            return parts, total
        for pn, p in work.named_parameters():    # MeshParams.coord_model
            x = tensors[pn]
            gather_block(x, ts.model_block(x.shape, x.sharding,
                                           all_coords[0]), p.data)
        ax = LeadAxis(work, M)
        parts = ts.group_pass(work, cfg, batch, 0, rows, size, denoms,
                              tp=ax)
        total = ts.model_axis_grads([work], tensors,
                                    [all_coords[i] for i in axis0], META)
        for p in work.parameters():
            p.grad = None
        moves[len(static):] = [(i, op, b, mv) for c in coords
                               for i in axes[c] for op, b, mv in ax.moves]
        return parts, total

    def lead_step():
        parts, total = group_grads()
        if tp:
            for pn in read_whole:                # read whole by AdamW
                gather(tensors[pn], out=wparams[pn])
        for _ in range(G - 1):                   # the others' gradients
            total = {pn: g + torch.empty_like(g) for pn, g in total.items()}
        err = ({pn: _meta(params[pn].shape, torch.float32)
                for pn in params} if compress else None)  # gather_tree(err)
        total, e_new, gn = ts.finish_grads(
            total, n_mb if microbatch else None, err)
        if compress:
            for pn in params:
                e = blocks[f"err/{pn}"].shards[0]
                e.copy_(e_new[pn][shard_slices(e_new[pn].shape,
                                               shards[f"err/{pn}"], lead)])
        updated = {}
        new_m, new_v = ts.coord_update(tensors, total, opt_in, gn, wparams,
                                       ranks, opt_cfg, 0, lead, META,
                                       updated)
        for pn, whole in updated.items():        # write(), the lead's block
            blk = tensors[pn]
            blk.shards[0].copy_(whole[shard_slices(blk.shape, blk.sharding,
                                                   lead)])
        return ({pn: x.shards[0] for pn, x in tensors.items()}, new_m,
                new_v, parts, gn)

    # the bytes moved: the gather at each group lead (with tp: at each
    # group's model coordinates, of their model blocks, and group 0's
    # gradients at the lead, the blocks joined and the replicated
    # leaves' copies summed), the gradient sum at the lead and each
    # coordinate's block of it, the compression's error feedback, the
    # int8 leaves updated in the moment's layout; with tp, the
    # activations' moves are booked by the pass (``LeadAxis``)
    if tp:
        for pn, p in params.items():             # blocks equal in shape
            want = math.prod(mblock[pn]) * p.element_size()
            own = _nbytes(_block(p, p_shard[pn]))
            if want > own:
                moves += [(i, "all-gather", want, want - own)
                          for c in coords for i in axes[c]]
            if want < _nbytes(p):                # group 0's blocks joined
                moves.append((0, "all-gather", _nbytes(p),
                              _nbytes(p) - want))
            else:                                # the copies summed
                moves.append((0, "all-reduce", want, (M - 1) * want))
        for pn in read_whole:
            moves += _gathers(0, {pn: params[pn]}, p_shard, n)
    else:
        for c in coords:
            moves += _gathers(c, params, p_shard, n)
    if G > 1:                                    # gradients: params' shape
        moves += [(0, "reduce-scatter", _nbytes(p), (G - 1) * _nbytes(p))
                  for p in params.values()]
    moves += _scatters(params, p_shard, n, "reduce-scatter")
    if compress:
        errs = {pn: args[f"err/{pn}"] for pn in params}
        moves += _gathers(0, errs, p_shard, n) + _scatters(errs, p_shard, n)
    for pn, x in tensors.items():
        m = opt_in.m[pn]
        if not isinstance(m, QTensor):
            continue
        mis = {}                                 # updated in moment layout
        for i, c in enumerate(mesh_coords(mesh)):
            region = ts._moment_region(x, m, c, opt_cfg.q_block)
            if region != shard_slices(x.shape, x.sharding, c):
                mis[i] = (math.prod(r.stop - r.start for r in region)
                          * x.shards[0].element_size())
        if mis:
            moves += [(i, "collective-permute", b, b)
                      for i, b in mis.items() if i]
            moves.append((0, "all-gather", _nbytes(params[pn]),
                          sum(b for i, b in mis.items() if i)))
            moves += _scatters({pn: params[pn]}, p_shard, n)
    static = list(moves)
    compute = {"placement": note, "groups": G, "rows_per_group": rows,
               "group_leads": coords,
               "counted": ("one group's pass (the groups' rows are equal "
                           "in shape), the gradient sum, the norm and "
                           "the lead's AdamW on its blocks")}
    if tp:
        compute["model_axis"] = M
        compute["counted"] = (
            "the lead's part of one group's pass: its blocks of the split "
            "pieces, its copy of the replicated activations and the "
            "pieces the model axis does not divide (the other "
            "coordinates' results arriving as stand-ins), the gradient "
            "blocks joined and summed, the norm and its AdamW on its "
            "blocks")
        work_bytes = sum(math.prod(mblock[pn]) * p.element_size()
                         for pn, p in params.items())
    else:
        work_bytes = sum(_nbytes(p) for p in params.values())
    return LoweringPlan(
        name, "train", mesh, lead_step, args, shards, moves=moves,
        work_bytes=work_bytes, compute=compute)


def _serve_plan(cfg, name, kind, mesh, B, S, rules):
    model = abstract_params(cfg)
    params = dict(model.named_parameters())
    p_shard = sh.param_shardings(params, mesh, rules)
    args = {f"params/{n}": p for n, p in params.items()}
    shards = {f"params/{n}": p_shard[n] for n in params}
    if kind == "prefill":
        batch = _batch_specs(cfg, B, S, with_labels=False)
    elif cfg.embed_input:
        batch = {"tokens": _meta((B, 1), torch.int32)}
    else:
        batch = {"embeds": _meta((B, 1, cfg.d_model), torch.bfloat16)}
    if kind == "decode" and cfg.vision_tokens:
        batch["image_embeds"] = _meta((B, cfg.vision_tokens, cfg.d_model),
                                      torch.bfloat16)
    b_shard = _batch_shardings(batch, mesh)
    for k, v in batch.items():
        args[f"batch/{k}"], shards[f"batch/{k}"] = v, b_shard[k]
    # the caches: decode's inputs, prefill's outputs, placed alike
    caches = model.init_cache(B, S)
    c_leaves = {f"caches/{i}/{k}": v for i, c in enumerate(caches)
                for k, v in c.items()}
    c_shard = {k: NamedSharding(mesh, sh.cache_sharding(
        tuple(v.shape), mesh, shard_time=rules.get("kvseq") == "model"))
        for k, v in c_leaves.items()}
    if kind == "decode":
        args.update(c_leaves)
        shards.update(c_shard)
    x, ctx = _inputs(batch)

    def run(m, cs):
        if kind == "prefill":
            return m.prefill(x, max_len=S, ctx=ctx)[:2]
        return m.decode_step(x, cs, S - 1, ctx=ctx)

    compute = {"placement": "one device: the port serves the LM on one "
               "device", "groups": 1, "rows_per_group": B,
               "counted": "the whole step"}
    n = len(mesh.flat)
    if n == 1:
        return LoweringPlan(name, kind, mesh, lambda: run(model, caches),
                            args, shards, compute=compute)
    lead = mesh_coords(mesh)[0]
    tensors = {pn: _sharded(p, p_shard[pn]) for pn, p in params.items()}
    kept = {k: _sharded(v, c_shard[k]) for k, v in c_leaves.items()}
    work = abstract_params(cfg)
    wparams = dict(work.named_parameters())

    def lead_step():
        for pn, p in wparams.items():
            gather(tensors[pn], out=p.data)
        cs = None
        if kind == "decode":                     # the whole caches here
            cs = tuple({k: gather(kept[f"caches/{i}/{k}"], META)
                        for k in c} for i, c in enumerate(caches))
        logits, out = run(work, cs)
        mine = []                                # the lead keeps its block
        for i, c in enumerate(out):
            for k, v in c.items():
                blk = kept[f"caches/{i}/{k}"]
                idx = shard_slices(v.shape, blk.sharding, lead)
                if kind == "decode":
                    blk.shards[0].copy_(v[idx])
                    mine.append(blk.shards[0])
                else:
                    mine.append(v[idx].clone())
        return logits, mine

    moves = _gathers(0, params, p_shard, n)
    moves += _gathers(0, batch, b_shard, n)
    if kind == "decode":
        moves += _gathers(0, c_leaves, c_shard, n)
    moves += _scatters(c_leaves, c_shard, n)
    compute["placement"] = ("one device, the mesh's lead: the port serves "
                            "the LM on one device (the whole params and "
                            "caches there)")
    return LoweringPlan(
        name, kind, mesh, lead_step, args, shards, moves=moves, work_bytes=sum(_nbytes(p) for p in params.values()),
        compute=compute)


def make_plan(cfg: ModelConfig, shape_name: str, mesh: Mesh,
              *, compress: bool = False, microbatch: int = 0,
              rules_override: dict | None = None,
              shapes: dict | None = None) -> LoweringPlan:
    """The plan of one cell.  ``shapes`` (default ``SHAPES``) maps the
    shape name to (kind, global batch, seq); the dry-run's ``--test``
    passes a shrunken copy.  The JAX ``constrain_grads`` has no
    counterpart: it pins the gradients to the params' shardings (a
    reduce-scatter), where the port's mesh step sums whole gradients at
    the lead and each coordinate slices its block from them (ROADMAP
    14k (b))."""
    kind, B, S = (shapes or SHAPES)[shape_name]
    rules = arch_rules(cfg, kind)
    if rules_override:
        rules.update(rules_override)
    sharding_rules.set_rules(**{k: rules.get(k) for k in
                                ("expert", "kvseq")})
    sharding_rules.set_mesh(mesh)
    name = f"{cfg.name}/{shape_name}"
    if kind == "train":
        return _train_plan(cfg, name, mesh, B, S, rules, compress,
                           microbatch)
    return _serve_plan(cfg, name, kind, mesh, B, S, rules)

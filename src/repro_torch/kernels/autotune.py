"""Launch shapes of the swept CUDA kernels, and the table that picks them.

Counterpart of ``repro.kernels.autotune``.  Three kernels are compiled at
several launch shapes each: ``hausdorff_grid`` (phase 2's lanes kernel),
``bound_grid`` (phases 0/1) and ``min_sq_dists`` (the pair-axis kernel
under ``ops.directed_hausdorff_pairs``).  Each source lists its shapes in a
``*_VARIANTS`` macro and its C entry point takes the index of one of them;
:data:`VARIANTS` lists the same shapes in the same order.

* :func:`resolve` is the one decision point.  Every kernel wrapper calls it
  with the operands' shapes and device and launches the variant of the
  :class:`KernelConfig` it returns: explicit per-call arguments beat the
  table, and the table beats :data:`DEFAULTS`.
* :func:`ensure_tuned` is the one-time measured sweep.  Its caller (the
  engine's ``tune()``) hands it a runner per candidate; the fastest is
  installed per (device, op, shape bucket) and :func:`epoch` is bumped,
  but only where its gain over the default, round by round, exceeds the
  spread of those gains (:func:`pick`): otherwise the default is
  installed.
  Tuning is opt-in: until a sweep runs, every launch takes
  :data:`DEFAULTS`, which are the shapes the kernels were built with before
  the table existed, so an untuned process launches exactly what it did.

Every variant is bitwise equal to the plain version, so the table can only
change speed: the per-element arithmetic of a kernel is the same at every
launch shape (squares summed in coordinate order, built with
``-fmad=false``), and minima and maxima are exact under any reduction
order.  The engine's tuner checks it again at its probe shapes before it
admits a candidate (``repro_torch.engine.tune``).

Where this differs from the JAX package, because the card is not a TPU:

* **What a config holds.**  A :class:`KernelConfig` is the launch shape of
  a CUDA kernel (warps, rows a thread, minima a row, slots and queries a
  block, nodes held in registers), not TPU tiles, and it holds no
  kernel-versus-plain verdict and no size thresholds.
* **No plain-route candidate.**  A CUDA tensor always launches its kernel
  and a CPU tensor always takes the plain version
  (``repro_torch.kernels.ops``); the plain version is never a candidate on
  the card, so it serves nothing on the main path when a card is present.
  On the CPU there is nothing to tune.
* **Table key.**  :func:`table_key` holds the device's type and, for a
  card, its name (``torch.cuda.get_device_name``), so a table tuned on one
  card never serves another.
* **No environment overrides.**  ``REPRO_FORCE_KERNEL`` and
  ``REPRO_FORCE_REF`` have no counterpart: the device decides the route.
"""
from __future__ import annotations

import functools
import math
import statistics
import time
from dataclasses import asdict, dataclass

import torch

__all__ = [
    "KernelConfig", "VARIANTS", "DEFAULTS", "resolve", "lookup",
    "ensure_tuned", "pick", "set_config", "epoch", "table_key", "bucket",
    "report", "clear", "variant", "rows_per_block", "device_id",
]


@dataclass(frozen=True)
class KernelConfig:
    """The launch shape of one CUDA kernel.  A field the kernel has no use
    for stays None:

    * ``hausdorff_grid``: ``warps`` a block, query ``rows`` a thread;
    * ``min_sq_dists``: ``warps`` a block, query ``rows`` a thread,
      ``acc`` running minima a row;
    * ``bound_grid``: ``slots`` a block (one thread each), ``queries`` a
      block, corpus nodes held in registers at once (``reg``).
    """

    warps: int | None = None
    rows: int | None = None
    acc: int | None = None
    slots: int | None = None
    queries: int | None = None
    reg: int | None = None

    def fields(self) -> dict:
        """The fields this kernel uses."""
        return {k: v for k, v in asdict(self).items() if v is not None}


#: the launch shapes each source instantiates, in the order of its
#: ``*_VARIANTS`` macro (the index is the C entry point's ``variant``);
#: the first is the default
VARIANTS: dict[str, tuple[KernelConfig, ...]] = {
    "hausdorff_grid": (
        KernelConfig(warps=4, rows=2), KernelConfig(warps=2, rows=2),
        KernelConfig(warps=4, rows=1), KernelConfig(warps=4, rows=4)),
    "min_sq_dists": (
        KernelConfig(warps=8, rows=2, acc=2),
        KernelConfig(warps=4, rows=2, acc=2),
        KernelConfig(warps=8, rows=4, acc=2),
        KernelConfig(warps=8, rows=2, acc=1)),
    "bound_grid": (
        KernelConfig(slots=128, queries=4, reg=8),
        KernelConfig(slots=64, queries=4, reg=8),
        KernelConfig(slots=128, queries=2, reg=8),
        KernelConfig(slots=128, queries=8, reg=8)),
}

#: the shape each kernel launches until a sweep installs another: the
#: constants it was built with before the table existed
DEFAULTS: dict[str, KernelConfig] = {op: v[0] for op, v in VARIANTS.items()}

_table: dict[tuple, KernelConfig] = {}
_epoch: int = 0


def epoch() -> int:
    """Monotone table version, bumped by :func:`set_config` and
    :func:`clear`.  A cache whose entries close over a launch decision
    keys on it, so a table update retires them."""
    return _epoch


def bucket(n: int) -> int:
    """Power-of-two shape bucket (the ladder the engine pads batches to)."""
    b = 1
    n = int(n)
    while b < n:
        b *= 2
    return b


@functools.lru_cache(maxsize=None)
def _device_id(dev_type: str, index) -> tuple:
    if dev_type == "cuda":
        return ("cuda", torch.cuda.get_device_name(index))
    return (dev_type, dev_type)


def device_id(device) -> tuple:
    """(device type, device name): the card's name from
    ``torch.cuda.get_device_name``, the type again for any other device."""
    dev = torch.device(device)
    index = dev.index
    if dev.type == "cuda" and index is None:
        index = torch.cuda.current_device()
    return _device_id(dev.type, index)


def table_key(op: str, shape, device) -> tuple:
    """Key of one tuning decision: (device type, device name, op, bucketed
    shape).  Two cards of one name share their entries; a card of another
    name, or the CPU, never reads them."""
    return device_id(device) + (op,) + tuple(bucket(s) for s in shape)


def variant(op: str, cfg: KernelConfig) -> int:
    """The index of ``cfg`` among the shapes ``op``'s source instantiates;
    raises ValueError for a shape it was not built with."""
    try:
        return VARIANTS[op].index(cfg)
    except ValueError:
        raise ValueError(
            f"{op}: no variant {cfg.fields()} is built; the source has "
            f"{[c.fields() for c in VARIANTS[op]]}") from None


def rows_per_block(op: str, cfg: KernelConfig) -> int:
    """Query rows one block of ``op`` covers at launch shape ``cfg``
    (``kRowsPerBlock`` in its source)."""
    if op == "hausdorff_grid":
        return cfg.warps * 32 * cfg.rows
    if op == "min_sq_dists":
        return 32 * cfg.rows
    raise ValueError(f"{op}: no row blocks")


def lookup(op: str, shape, device) -> KernelConfig:
    """The table's entry for (device, op, shape bucket), else the
    default."""
    return _table.get(table_key(op, shape, device), DEFAULTS[op])


def resolve(op: str, shape, device,
            config: KernelConfig | None = None) -> KernelConfig:
    """The launch shape of one call: an explicit ``config`` beats the
    table, the table beats :data:`DEFAULTS`.  It must be a shape the
    source instantiates, or ValueError is raised."""
    cfg = config if config is not None else lookup(op, shape, device)
    variant(op, cfg)
    return cfg


def set_config(op: str, shape, device, cfg: KernelConfig) -> None:
    """Install one tuned entry and bump :func:`epoch`."""
    global _epoch
    variant(op, cfg)
    _table[table_key(op, shape, device)] = cfg
    _epoch += 1


def clear() -> None:
    """Drop every tuned entry (tests).  Bumps :func:`epoch`."""
    global _epoch
    _table.clear()
    _epoch += 1


def pick(samples, default: int | None = None):
    """The candidate to install from timed rounds: ``samples[i][r]`` is
    candidate i's time in round r.  A candidate's time is its median; its
    spread is its largest time less its smallest.  Against the default it
    is judged round by round, by the ratio of its time to the default's
    in that round, so a drift of the host that slows a whole round falls
    out: it qualifies only where its median gain (one less the median
    ratio) exceeds the spread of its ratios.  The fastest qualifying
    candidate wins, else the default stays, so a gap inside the noise of
    the rounds installs nothing.  With no default the fastest wins.
    Returns (index, medians, spreads)."""
    medians = [float(statistics.median(s)) for s in samples]
    spreads = [float(max(s) - min(s)) for s in samples]
    if default is None:
        return (min(range(len(samples)), key=medians.__getitem__),
                medians, spreads)

    def ratio(c, d):
        # a default that took no time is beaten by nothing
        return c / d if d > 0 else (math.inf if c > 0 else 1.0)

    def qualifies(i):
        ratios = [ratio(c, d) for c, d in zip(samples[i], samples[default])]
        return 1.0 - statistics.median(ratios) > max(ratios) - min(ratios)

    ok = [i for i in range(len(samples)) if i != default and qualifies(i)]
    best = min(ok, key=medians.__getitem__) if ok else default
    return best, medians, spreads


def ensure_tuned(op: str, shape, device, runner, candidates, *,
                 repeats: int = 3, force: bool = False,
                 timer=time.perf_counter):
    """One-time measured sweep for (device, op, shape bucket).

    ``runner(cfg)`` must run the op at launch shape ``cfg`` and wait until
    the result is ready.  It runs once per candidate to warm up; then
    ``repeats`` rounds time each candidate once, in turn, so a drift of
    the host within a round falls on all alike.  :func:`pick` chooses from the rounds,
    with ``DEFAULTS[op]`` as the default where it is a candidate, and the
    choice is installed through :func:`set_config` and returned with the
    medians (``timings_s``) and spreads.  A decision already in the table
    short-circuits (returning it and None) unless ``force=True``."""
    key = table_key(op, shape, device)
    if key in _table and not force:
        return _table[key], None
    candidates = list(candidates)
    for cfg in candidates:
        runner(cfg)                       # warm-up
    samples = [[] for _ in candidates]
    for _ in range(repeats):
        for i, cfg in enumerate(candidates):
            t0 = timer()
            runner(cfg)
            samples[i].append(timer() - t0)
    default = (candidates.index(DEFAULTS[op])
               if DEFAULTS[op] in candidates else None)
    best, medians, spreads = pick(samples, default)
    chosen = candidates[best]
    set_config(op, shape, device, chosen)
    return chosen, {"key": key, "timings_s": medians, "spreads_s": spreads,
                    "chosen": best}


def report() -> dict:
    """Every tuned decision (for the tuner's report and the smoke)."""
    return {
        "epoch": _epoch,
        "entries": {repr(k): {"variant": variant(k[2], v), **v.fields()}
                    for k, v in _table.items()},
    }

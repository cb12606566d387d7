"""The mesh of a run and its tensor-parallel rules (counterpart of
moonsuperresolution_tpu/parallel/mesh.py).

A mesh has two axes, ("data", "model"), in one of two modes:

- **several processes** (``initialize`` was called): one process per
  place, world size = the product of the shape, process ``r`` at
  ``divmod(r, model size)``.  Each axis has a process group: the data
  group of a process holds the processes of its model index, the model
  group those of its data index.  The data axis splits the batch (DP), the
  model axis the SPADE generator's large kernels (Megatron TP).
- **one process**: a grid of devices for the tile-parallel map engine, one
  tile per device of the data axis.  A device may appear more than once
  (the CPU is one device; two entries of one card run two tiles on two
  streams of it).

Where JAX's GSPMD inserts the collectives from shardings, the port's
modules call them (parallel/collectives.py): the SPADE and BatchNorm
moments all-reduce over the data group, the row-parallel layers over the
model group; the trainers average their gradients over the data group.

``param_sharding_rules`` makes JAX's decisions (its mesh.py:50-113) on the
port's dotted parameter names (torch layouts: conv ``[out, in, kh, kw]``,
dense ``[out, in]``):

- ``resblock_*.conv_1`` / ``conv_3`` weights: column-parallel (dim 0) when
  their out-channels are >= ``min_dim`` and divide by the model size;
- ``resblock_*.conv_2`` weights: row-parallel (dim 1) likewise on their
  in-channels;
- the generator's latent ``dense``: row-parallel over the latent dim (dim
  1) when that divides and its out-features are >= ``min_dim``;
- everything else is replicated: biases (a column-parallel conv slices its
  bias where it uses it), the SPADE gamma/beta convs (the sharded SPADE
  uses its own output-channel slice of them), the encoder, the
  discriminator, VGG and odd widths.

A resblock's conv_1 out-width is conv_2's in-width and conv_3's out-width,
so a block is sharded whole or not at all.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from moonsuperresolution_tpu_torch.device import process_device, resolve_device
from moonsuperresolution_tpu_torch.parallel.collectives import (
    ONE,
    Axis,
    gather_whole,
)

AXES = ("data", "model")
TP_DIM = {"column": 0, "row": 1}
_ADAM_MOMENTS = ("exp_avg", "exp_avg_sq")


@dataclasses.dataclass
class Mesh:
    """``shape``: {axis name: size}.  ``device``: this process's device.
    ``devices``: one process's grid of devices (shape of the mesh), None
    across processes.  ``data`` / ``model``: this process's place and
    groups on each axis (``ONE`` in one process)."""

    shape: dict
    device: torch.device
    devices: Optional[np.ndarray] = None
    data: Axis = ONE
    model: Axis = ONE

    @property
    def multiprocess(self) -> bool:
        return self.devices is None

    def data_devices(self) -> list[torch.device]:
        """One process's devices along the data axis (model index 0)."""
        return list(self.devices[:, 0])


def make_mesh(shape: Optional[tuple] = None, axis_names: tuple = AXES,
              devices=None, device=None) -> Mesh:
    """A mesh; ``shape=None`` puts every process (or device) on the data
    axis.

    In a process group (``parallel.distributed.initialize``), the world
    size must be the product of ``shape``; ``device`` is this process's
    device as ``initialize`` chose it (None: its card; "cpu").  Every
    process must call this with the same shape: it creates the groups.

    In one process, ``devices`` (torch devices or their names, repeats
    allowed) fills the grid in row-major order; by default ``device`` at
    every place, or else every card.
    """
    if tuple(axis_names) != AXES:
        raise ValueError(f"the port's meshes have the axes {AXES}")
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        shape = tuple(shape or (world, 1))
        if len(shape) != 2 or math.prod(shape) != world:
            raise ValueError(f"mesh {shape} does not hold the {world} "
                             f"processes of this run")
        d_size, m_size = shape
        d_idx, m_idx = divmod(rank, m_size)
        data = model = None
        # Every process creates every group, in one order.
        for m in range(m_size):
            g = dist.new_group([d * m_size + m for d in range(d_size)])
            if m == m_idx:
                data = Axis(g, d_idx, d_size)
        for d in range(d_size):
            g = dist.new_group([d * m_size + m for m in range(m_size)])
            if d == d_idx:
                model = Axis(g, m_idx, m_size)
        return Mesh(dict(zip(AXES, shape)), process_device(device, rank),
                    None, data, model)
    if devices is None and device is not None:
        devices = [device] * math.prod(shape or (1, 1))
    elif devices is None:
        resolve_device(None)        # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    shape = tuple(shape or (len(devices), 1))
    if len(shape) != 2 or math.prod(shape) != len(devices):
        raise ValueError(f"mesh {shape} does not hold the {len(devices)} "
                         f"devices {devices}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(dict(zip(AXES, shape)), devices[0], grid.reshape(shape))


def param_sharding_rules(mesh: Mesh, min_dim: int = 512):
    """``rule(name, x) -> "column" | "row" | "replicate"`` for a parameter
    of the port's dotted ``name`` and its tensor (or shape) ``x``; the
    decisions of JAX's ``param_sharding_rules`` (see the module
    docstring)."""
    model_size = mesh.shape["model"]

    def rule(name: str, x) -> str:
        shape = tuple(getattr(x, "shape", x))
        if model_size <= 1 or len(shape) < 2:
            return "replicate"
        path = "." + name
        is_resblock = "resblock_" in name
        if (is_resblock
                and (".conv_1.weight" in path or ".conv_3.weight" in path)
                and shape[0] >= min_dim and shape[0] % model_size == 0):
            return "column"
        if (is_resblock and ".conv_2.weight" in path
                and shape[1] >= min_dim and shape[1] % model_size == 0):
            return "row"
        if ("generator" in name and name.endswith("dense.weight")
                and shape[1] % model_size == 0 and shape[0] >= min_dim):
            return "row"
        return "replicate"

    return rule


def shard_state_for_dp_tp(trainer, mesh: Mesh, min_dim: int = 512):
    """Puts a trainer on a multi-process mesh, in place; returns it.

    Every SPADE and BatchNorm of its networks takes its moments over the
    data group and the trainer averages its gradients there.  The
    parameters that ``param_sharding_rules`` shards keep this process's
    slice on the model axis, and so do their Adam moments and
    ``grad_accum`` sums; the blocks and the latent dense that hold them run
    tensor-parallel.  Call it on a whole trainer (initialised or restored),
    the same on every process."""
    if not mesh.multiprocess:
        if math.prod(mesh.shape.values()) > 1:
            raise ValueError("training on a mesh runs one process per place "
                             "of it: initialize the process group first")
        return trainer
    if getattr(trainer, "mesh", None) is not None:
        raise ValueError("the trainer is on a mesh already")
    rule = param_sharding_rules(mesh, min_dim)
    sharded = {name: TP_DIM[how]
               for name, p in trainer.nets.named_parameters()
               if (how := rule(name, p)) != "replicate"}
    for module in trainer.nets.modules():
        if hasattr(module, "data_axis"):
            module.data_axis = mesh.data
    gen = trainer.nets["generator"] if "generator" in trainer.nets else None
    for name, block in (gen.named_children() if gen is not None else ()):
        if not name.startswith("resblock_"):
            continue
        convs = [f"generator.{name}.conv_{i}.weight" for i in (1, 2, 3)
                 if getattr(block, f"conv_{i}") is not None]
        split = {c in sharded for c in convs}
        if len(split) != 1:
            raise ValueError(f"{name}: its convs shard unevenly ({convs})")
        if split.pop():
            block.model_axis = mesh.model
    if "generator.dense.weight" in sharded:
        gen.model_axis = mesh.model

    part = {}     # parameter -> (dim, this process's slice)
    for name, p in trainer.nets.named_parameters():
        if name in sharded:
            dim = sharded[name]
            part[p] = dim, mesh.model.part(p.shape[dim])
    for opt, prefix in _optimizers(trainer):
        params = _opt_params(opt)
        for i, p in enumerate(params):
            if p not in part:
                continue
            dim, sl = part[p]
            state = opt.state.get(p, {})
            for k in _ADAM_MOMENTS:
                if k in state:
                    state[k] = _take(state[k], dim, sl)
            key = f"{prefix}{i}"
            if key in trainer.accum:
                trainer.accum[key] = _take(trainer.accum[key], dim, sl)
    with torch.no_grad():
        for p, (dim, sl) in part.items():
            p.data = _take(p.data, dim, sl)
    trainer.mesh, trainer.sharded = mesh, sharded
    trainer.sharded_params = frozenset(part)
    trainer.data_axis, trainer.model_axis = mesh.data, mesh.model
    return trainer


def _take(t: torch.Tensor, dim: int, sl: slice) -> torch.Tensor:
    return t.narrow(dim, sl.start, sl.stop - sl.start).clone()


def _optimizers(trainer):
    """(optimizer, ``grad_accum`` key prefix) of each of its optimizers."""
    out = [(trainer.gen_opt, "g")]
    if trainer.disc_opt is not None:
        out.append((trainer.disc_opt, "d"))
    return out


def _opt_params(opt) -> list:
    return [p for group in opt.param_groups for p in group["params"]]


def whole_state(trainer) -> dict:
    """The trainer's state with every sharded tensor gathered whole: the
    ``nets`` state dict, each optimizer's state dict and the
    ``grad_accum`` sums, as ``utils/checkpoint.py`` saves them.  The same
    on every process; every process must call it."""
    sharded = getattr(trainer, "sharded", None) or {}
    model = trainer.mesh.model if sharded else ONE
    names = {p: n for n, p in trainer.nets.named_parameters()}

    def whole(name, t):
        dim = sharded.get(name)
        return t if dim is None else gather_whole(t, model, dim)

    nets = {k: whole(k, v) for k, v in trainer.nets.state_dict().items()}
    opts, accum = {}, {}
    for opt, prefix in _optimizers(trainer):
        params = _opt_params(opt)
        sd = opt.state_dict()
        sd["state"] = {
            i: {k: (whole(names[params[i]], v) if k in _ADAM_MOMENTS else v)
                for k, v in st.items()}
            for i, st in sd["state"].items()}
        opts[prefix] = sd
        for key, v in trainer.accum.items():
            if key.startswith(prefix) and key[1:].isdigit():
                accum[key] = whole(names[params[int(key[1:])]], v)
    return {"nets": nets, "gen_opt": opts["g"], "disc_opt": opts.get("d"),
            "accum": accum}


def shard_batch(batch, mesh: Mesh):
    """A global batch's rows for this process (several processes: its part
    of axis 0 on the data axis, on its device), or, in one process, one
    part per device of the data axis (a list).  ``batch``: an array or
    tensor, or a tuple of them."""
    if isinstance(batch, tuple):
        parts = [shard_batch(b, mesh) for b in batch]
        return tuple(parts) if mesh.multiprocess else list(zip(*parts))
    t = torch.as_tensor(batch)
    if mesh.multiprocess:
        return t[mesh.data.part(t.shape[0])].to(mesh.device)
    devs = mesh.data_devices()
    return [c.to(d) for c, d in zip(t.chunk(len(devs)), devs)]

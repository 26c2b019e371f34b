"""Ranks, the (data, model) mesh and its collectives over `torch.distributed`
(counterpart of `sosvo/dist/mesh.py`).

Ranks are processes. `init_process_group` starts this process's rank from
its arguments or from the launcher's environment (`torchrun`, or
`sosvo_torch/dist/launch.py`), and `make_mesh` lays the ranks out as the
JAX package's mesh lays out its devices: rank = d * model + m for data
index d and model index m, axis "data" for independent work (batched
sequences, loop-candidate pairs, pose-graph time blocks) and axis "model"
for BA landmark shards. An `Axis` is one axis as this rank sees it: its
size, this rank's index on it, and its collectives, the counterparts of
`psum`, `all_gather` and the ring `ppermute` of `sosvo/dist/pgo_time.py`.

The backend is chosen by a rule, printed, and never picked by catching an
error (`choose_backend`): NCCL when every rank has a card of its own, gloo
when ranks share a card (one H100 and 8 ranks: NCCL refuses two ranks on
one device) or run on the CPU. Tensors stay on each rank's device:
`cuda:{local_rank % device_count}`, or the CPU where the caller asks. The
exchanges are `all_reduce`, `all_gather_into_tensor` and `broadcast` on
either backend (gloo takes all three on CUDA tensors); the ring halo is a
neighbour's row of the all-gather.

Under gloo an exchange of CUDA tensors is staged through host memory: gloo
copies the buffer to the host, reduces it on the CPU in its own worker
thread and copies the result back, and the calling thread waits in
`work.wait()` until the card has produced the tensor. So under gloo every
collective is one host sync that PyTorch's sync debug mode cannot see (it
happens in gloo's C++ thread): count them from `calls`. Under NCCL the
exchange stays on the card and the host does not wait.

At world size 1 no process group exists and every collective is the
identity: the one-device mesh the JAX command line clamps to on one chip.
`calls` counts the collectives each axis issues (for the measurement tools).
"""

from __future__ import annotations

import collections
import datetime
import os
import sys
from typing import NamedTuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

calls: collections.Counter = collections.Counter()  # collectives issued, by kind


def reset_calls() -> None:
    calls.clear()


class Ranks(NamedTuple):
    """This process's place among the ranks."""

    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: str | None  # None at world size 1: no process group


def choose_backend(device: torch.device, local_world: int) -> tuple[str, str]:
    """(backend, why): NCCL when every rank of this host has a CUDA card of
    its own, gloo when ranks share a card or hold CPU tensors."""
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards >= local_world:
            return "nccl", f"{local_world} ranks on {cards} cards, one card each"
        return "gloo", f"{local_world} ranks share {cards} card(s); NCCL takes one rank per card"
    return "gloo", "CPU tensors"


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def rank_device(device: torch.device | str | None, local_rank: int) -> torch.device:
    """The rank's device: the CPU where asked, else `cuda:{local_rank %
    device_count}`."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("sosvo_torch.dist: no CUDA device; pass device=\"cpu\" to run ranks "
                           "on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_process_group(device: torch.device | str | None = None, rank: int | None = None,
                       world_size: int | None = None, init_method: str | None = None,
                       timeout_s: float = 600.0, verbose: bool = True) -> Ranks:
    """Start this rank (counterpart of `init_multihost`). Rank and world
    size come from the arguments, else from RANK / WORLD_SIZE / LOCAL_RANK /
    LOCAL_WORLD_SIZE (torchrun and `dist/launch.py` set them); the
    rendezvous from `init_method`, else SOSVO_DIST_INIT, else torchrun's
    `env://`. At world size 1 no group is started. Prints the backend, why,
    and the world size on rank 0. Collectives that wait longer than
    `timeout_s` fail."""
    rank = _env_int("RANK", 0) if rank is None else rank
    world = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world == 1:
        return Ranks(0, 1, 0, dev, None)
    if dist.is_initialized():
        return Ranks(dist.get_rank(), dist.get_world_size(), local_rank, dev, dist.get_backend())
    backend, why = choose_backend(dev, local_world)
    init = init_method or os.environ.get("SOSVO_DIST_INIT") or "env://"
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if verbose and rank == 0:
        print(f"[sosvo_torch.dist] backend={backend} world={world} device={dev.type} ({why})",
              file=sys.stderr, flush=True)
    return Ranks(rank, world, local_rank, dev, backend)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


class Axis:
    """One mesh axis as this rank sees it. `group` is None at size 1, where
    every collective returns its input."""

    def __init__(self, name: str, size: int, index: int, group):
        self.name, self.size, self.index, self.group = name, size, index, group

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, size={self.size}, index={self.index})"

    def psum(self, *xs: torch.Tensor):
        """Sum each tensor over the axis; several tensors of one dtype go
        in one flat buffer. Returns one tensor or a tuple, as given."""
        if self.size == 1:
            return xs[0] if len(xs) == 1 else xs
        calls[f"{self.name}.psum"] += 1
        flat = torch.cat([x.reshape(-1) for x in xs])
        dist.all_reduce(flat, group=self.group)
        out = tuple(p.view(x.shape) for p, x in
                    zip(flat.split_with_sizes([x.numel() for x in xs]), xs))
        return out[0] if len(out) == 1 else out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size * n, ...) the axis's shards of x (n, ...) in index order."""
        if self.size == 1:
            return x
        calls[f"{self.name}.all_gather"] += 1
        shape = (self.size * x.shape[0],) + tuple(x.shape[1:]) if x.dim() else (self.size,)
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=self.group)
        return out

    def from_next(self, x: torch.Tensor) -> torch.Tensor:
        """The ring halo: x as the next index (index + 1 mod size) holds it
        (`ppermute` by one, `sosvo/dist/pgo_time.py:_pull_next_first`)."""
        if self.size == 1:
            return x
        return self.all_gather(x[None])[(self.index + 1) % self.size]

    def from_prev(self, x: torch.Tensor) -> torch.Tensor:
        """The reverse halo: x as the previous index holds it
        (`_push_to_next_first`)."""
        if self.size == 1:
            return x
        return self.all_gather(x[None])[(self.index - 1) % self.size]

    def broadcast(self, x: torch.Tensor, src_index: int = 0) -> torch.Tensor:
        """x as index `src_index` holds it, on every index (in place)."""
        if self.size == 1:
            return x
        calls[f"{self.name}.broadcast"] += 1
        # gloo broadcasts no bool: the same bytes as uint8
        dist.broadcast(x.view(torch.uint8) if x.dtype == torch.bool else x,
                       src=dist.get_global_rank(self.group, src_index), group=self.group)
        return x

    def broadcast_list(self, tensors: list | None, device: torch.device,
                       src_index: int = 0) -> list:
        """The tensors index `src_index` holds (pass None elsewhere), on
        every index's `device`: their shapes and dtypes go first, then each
        tensor, device to device."""
        if self.size == 1:
            return tensors
        meta = [[(tuple(t.shape), t.dtype) for t in tensors] if self.index == src_index else None]
        calls[f"{self.name}.broadcast_object"] += 1
        dist.broadcast_object_list(meta, src=dist.get_global_rank(self.group, src_index),
                                   group=self.group)
        if self.index != src_index:
            tensors = [torch.empty(shape, dtype=dtype, device=device) for shape, dtype in meta[0]]
        return [self.broadcast(t.contiguous(), src_index) for t in tensors]


class Mesh(NamedTuple):
    """A (data, model) layout of ranks: rank d * model + m. Ranks at or
    beyond data * model are not `member`s (their axes have size 1)."""

    data: int
    model: int
    ranks: Ranks
    axes: dict

    @property
    def member(self) -> bool:
        return self.ranks.rank < self.data * self.model

    @property
    def device(self) -> torch.device:
        return self.ranks.device

    def axis(self, name: str) -> Axis:
        return self.axes[name]


def make_mesh(ranks: Ranks, data: int = 1, model: int = 1) -> Mesh:
    """The (data, model) mesh over the first data * model ranks (`make_mesh`
    of the JAX package; `model_mesh(n)` is make_mesh(ranks, 1, n) and
    `data_mesh(n)` make_mesh(ranks, n, 1)). Every rank of the world calls
    it, in the same order, members or not."""
    if data * model > ranks.world:
        raise ValueError(f"need {data * model} ranks for mesh ({data}x{model}), "
                         f"have {ranks.world}")
    r = ranks.rank
    member = r < data * model
    d, m = (r // model, r % model) if member else (0, 0)
    groups = {}
    if ranks.world > 1:
        # new_group is collective: every rank creates every group, in order.
        for name, size, members in (
                (MODEL_AXIS, model, [[dd * model + mm for mm in range(model)] for dd in range(data)]),
                (DATA_AXIS, data, [[dd * model + mm for dd in range(data)] for mm in range(model)])):
            if size == 1:
                continue
            for ranks_of in members:
                g = dist.new_group(ranks_of)
                if r in ranks_of:
                    groups[name] = g
    axes = {MODEL_AXIS: Axis(MODEL_AXIS, model if member else 1, m, groups.get(MODEL_AXIS)),
            DATA_AXIS: Axis(DATA_AXIS, data if member else 1, d, groups.get(DATA_AXIS))}
    return Mesh(data, model, ranks, axes)


def single(device: torch.device | str | None = None) -> Ranks:
    """The ranks of one process with no group: every axis of a mesh over
    it has size 1. Its device is the card unless `device` is the CPU
    (`rank_device` of rank 0)."""
    return Ranks(0, 1, 0, rank_device(device, 0), None)

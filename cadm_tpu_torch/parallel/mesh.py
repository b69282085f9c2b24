"""A (dp, model) mesh of ``torch.distributed`` ranks (counterpart of
cadm_tpu/parallel/mesh.py).

One process per rank, launched by ``torchrun`` or by ``spawn`` below; the
ranks form a (dp, model) grid laid out dp-major (rank = dp index · model +
model index), as ``np.asarray(devices).reshape(dp, model)`` in the
reference:

- ``dp``: env-batch data parallelism. Each dp index holds one block of the
  envs, their histories and their replay-ring rows; the collect (planner,
  kernels K1/K2 on the block, ring writes) needs no communication.
- ``model``: ensemble-member parallelism. Each model index holds one block
  of the member-stacked forward/backward heads and their Adam moments and
  computes its members' loss; the gradients of the shared leaves (encoder,
  log-variance bounds) are summed over ``model``.

The reference's mesh changes where arrays live and never what is computed:
XLA partitions one global program, and its random draws are global arrays.
So here a run on a mesh computes what the same run computes without one,
within float32 reduction order:

- every draw whose shape depends on the env count is made at the shape of
  all envs, from the same generator on every rank, and the rank keeps its
  block (``core/rng.py``), so the generators stay in step on every rank;
- the fit gathers each minibatch over ``dp`` (every dp rank computes the
  same full-batch step), the planner plans with every member (heads
  gathered over ``model``), and metrics are computed from gathered values.

Every collective is an ``all_reduce`` (SUM): a gather is the all-reduce of
a zero-filled buffer in which each rank writes its own block, so the same
code runs on nccl and on gloo, which takes CUDA tensors for all-reduce. The
backend is nccl when every rank has a CUDA device of its own and gloo when
the ranks are on the CPU or share a card (nccl refuses two ranks on one
device); ``make_mesh`` prints its choice and never switches.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from cadm_tpu_torch.core.types import resolve_device, tree_map

Tensor = torch.Tensor


def _torchrun_line(n: int) -> str:
    return (f"torchrun --nproc-per-node {n} -m cadm_tpu_torch.cli.run "
            f"--dp ... --model-par ... [flags]")


class Mesh:
    """This rank's place on the (dp, model) grid, its device and the
    process groups of its two axes. Built by ``make_mesh``."""

    def __init__(self, dp: int, model: int, rank: int, device: torch.device,
                 backend: str, groups: dict):
        self.dp, self.model, self.rank = dp, model, rank
        self.device, self.backend = device, backend
        self._groups = groups

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, model={self.model}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")

    def size(self, axis: str) -> int:
        """The number of ranks of ``axis``: "dp", "model" or "world"."""
        return {"dp": self.dp, "model": self.model,
                "world": self.dp * self.model}[axis]

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return {"dp": self.rank // self.model, "model": self.rank % self.model,
                "world": self.rank}[axis]

    def local_count(self, n: int, axis: str, what: str = "items") -> int:
        """``n`` / the size of ``axis``; a ``ValueError`` that names the
        divisibility where it does not divide (as the reference's
        ``device_put`` for a sharded axis)."""
        k = self.size(axis)
        if n % k:
            raise ValueError(f"{n} {what} are not divisible by the mesh's "
                             f"{axis} axis of {k}")
        return n // k

    # ----------------------------------------------------------- blocks --
    def take(self, x: Tensor, axis: str, dim: int = 0) -> Tensor:
        """This rank's block of ``x`` along ``dim`` (the axis's size
        blocks)."""
        n = self.local_count(x.shape[dim], axis)
        return x.narrow(dim, self.index(axis) * n, n)

    def sum(self, tensors: Sequence[Tensor], axis: str) -> List[Tensor]:
        """The SUM over the ranks of ``axis`` of each tensor (new tensors),
        in one all-reduce per dtype: float32 as it is, every other dtype
        through float64 (exact for bools and int32)."""
        out: List[Optional[Tensor]] = [None] * len(tensors)
        for wide in (False, True):
            idx = [i for i, x in enumerate(tensors)
                   if (x.dtype != torch.float32) == wide]
            if not idx:
                continue
            dtype = torch.float64 if wide else torch.float32
            flat = torch.cat([tensors[i].reshape(-1).to(dtype) for i in idx])
            dist.all_reduce(flat, group=self._groups[axis])
            for i, part in zip(idx, flat.split([tensors[i].numel()
                                                for i in idx])):
                out[i] = part.view(tensors[i].shape).to(tensors[i].dtype)
        return out

    def gather(self, tensors: Sequence[Tensor], axis: str, dim: int = 0
               ) -> List[Tensor]:
        """Each tensor's blocks of every rank of ``axis``, concatenated
        along ``dim`` in index order, bit for bit: one all-reduce per dtype
        (bools as uint8) of a zero-filled buffer in which this rank writes
        its blocks. The results are views of that buffer, so a gather holds
        no more than the gathered tensors."""
        k, i = self.size(axis), self.index(axis)
        by_dtype: dict = {}
        for j, x in enumerate(tensors):
            by_dtype.setdefault(x.dtype, []).append(j)
        out: List[Optional[Tensor]] = [None] * len(tensors)
        for dtype, idx in by_dtype.items():
            wire = torch.uint8 if dtype == torch.bool else dtype
            sizes = [tensors[j].numel() * k for j in idx]
            flat = torch.zeros(sum(sizes), dtype=wire,
                               device=tensors[idx[0]].device)
            for j, part in zip(idx, flat.split(sizes)):
                x = tensors[j]
                shape = list(x.shape)
                n, shape[dim] = shape[dim], shape[dim] * k
                full = part.view(shape)
                full.narrow(dim, i * n, n).copy_(x)
                out[j] = full.view(dtype)
            dist.all_reduce(flat, group=self._groups[axis])
        return out

    def sum_tree(self, tree, axis: str):
        """``sum`` of every tensor of a tree (dataclasses, dicts, lists;
        numbers kept)."""
        return self._per_leaf(tree, lambda xs: self.sum(xs, axis))

    def gather_tree(self, tree, axis: str = "dp", dim: int = 0):
        """``gather`` of every tensor of a tree."""
        return self._per_leaf(tree, lambda xs: self.gather(xs, axis, dim))

    @staticmethod
    def _per_leaf(tree, fn):
        leaves: List[Tensor] = []
        tree_map(leaves.append, tree)
        it = iter(fn(leaves))
        return tree_map(lambda _: next(it), tree)

    def close(self) -> None:
        """Destroy the process groups."""
        dist.destroy_process_group()


# ------------------------------------------------------------ placement --
def writes_files(mesh: Optional[Mesh]) -> bool:
    """Does this process write the run's files (logs, checkpoints, dumps)?
    Rank 0 does, and a run without a mesh."""
    return mesh is None or mesh.rank == 0


def shard_leading_axis(tree, mesh: Optional[Mesh], axis: str = "dp"):
    """This rank's block of every tensor whose leading axis divides the
    size of ``axis``; the rest (numbers such as the ring's ptr/size, and
    tensors that do not divide) whole. ``tree`` itself without a mesh."""
    if mesh is None:
        return tree
    k = mesh.size(axis)
    return tree_map(lambda x: mesh.take(x, axis).clone()
                    if x.ndim >= 1 and x.shape[0] % k == 0 else x, tree)


def gather_leading_axis(tree, mesh: Optional[Mesh], dim: int = 0):
    """The inverse of ``shard_leading_axis`` for trees whose tensors all
    split along ``dim`` (env states, histories, rings, rollouts): every dp
    rank's blocks."""
    return tree if mesh is None else mesh.gather_tree(tree, "dp", dim)


def _heads(params: dict, keys: Sequence[str], fn) -> dict:
    return {k: tree_map(fn, v) if k in keys else v for k, v in params.items()}


def shard_dynamics_state(state, mesh: Optional[Mesh],
                         member_keys: Sequence[str]):
    """A model state with this rank's members of the member-stacked
    params ``member_keys`` (the model's ``member_keys``) and of their Adam
    moments; everything else replicated. Raises ``ValueError`` where the
    members do not divide the model axis. ``state`` itself without a
    mesh."""
    if mesh is None:
        return state

    def take(x):
        return mesh.take(x, "model")

    opt = state.opt_state
    return dataclasses.replace(
        state, params=_heads(state.params, member_keys, take),
        opt_state=opt if opt is None else dataclasses.replace(
            opt, mu=_heads(opt.mu, member_keys, take),
            nu=_heads(opt.nu, member_keys, take)))


def gather_dynamics_state(state, mesh: Optional[Mesh],
                          member_keys: Sequence[str]):
    """The inverse of ``shard_dynamics_state``: every member of the
    ``member_keys`` params and of their Adam moments, on every rank."""
    if mesh is None or not member_keys:
        return state
    opt = state.opt_state
    trees = [state.params] + ([] if opt is None else [opt.mu, opt.nu])
    heads = [{k: t[k] for k in member_keys if k in t} for t in trees]
    full = mesh.gather_tree(heads, "model")
    params, *moments = [{**t, **h} for t, h in zip(trees, full)]
    return dataclasses.replace(
        state, params=params, opt_state=opt if opt is None else
        dataclasses.replace(opt, mu=moments[0], nu=moments[1]))


# ----------------------------------------------------------- the mesh --
def launched_world_size() -> int:
    """The launcher's world size (``WORLD_SIZE``, set by torchrun)."""
    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            "a mesh needs one process per rank and none was launched (no "
            f"WORLD_SIZE): run under `{_torchrun_line(2)}` with "
            "--nproc-per-node = dp × model-par")
    return int(os.environ["WORLD_SIZE"])


def _cards_for_local_ranks(world: int) -> List[torch.device]:
    """Under torchrun: rank r on ``cuda:(r mod local world size)``."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if not torch.cuda.is_available() or torch.cuda.device_count() < local:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise ValueError(
            f"{local} local ranks need {local} CUDA cards and this machine "
            f"has {have}: launch at most one rank per card "
            f"(`{_torchrun_line(max(have, 1))}`), or pass --device cpu")
    return [torch.device("cuda", r % local) for r in range(world)]


def make_mesh(dp: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None, *,
              rank: Optional[int] = None,
              init_method: Optional[str] = None) -> Mesh:
    """Initialise the process group and build this rank's (dp, model)
    mesh; ``dp`` defaults to world size // model.

    ``devices``: every rank's device, in rank order (one per rank; ranks
    may share one). By default the launcher's world (``WORLD_SIZE``) with
    rank r on card ``LOCAL_RANK``. ``rank`` and ``init_method`` default to
    the launcher's (``RANK``, ``env://``). Raises where dp × model is not
    the world size.
    """
    world = len(devices) if devices is not None else launched_world_size()
    if dp is None:
        dp = world // model
    if dp < 1 or model < 1 or dp * model != world:
        raise ValueError(
            f"a (dp={dp}, model={model}) mesh needs {dp * model} ranks and "
            f"this run has {world}: launch it as "
            f"`{_torchrun_line(max(dp * model, 1))}`")
    devices = ([torch.device(d) for d in devices] if devices is not None
               else _cards_for_local_ranks(world))
    rank = int(os.environ["RANK"]) if rank is None else rank
    device = devices[rank]
    own_cards = (all(d.type == "cuda" for d in devices)
                 and len(set(devices)) == world)
    backend = "nccl" if own_cards else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world)
    groups = {"world": None}  # None: the default group
    # every rank creates every group, in the same order
    for d in range(dp):
        g = dist.new_group([d * model + m for m in range(model)])
        if d == rank // model:
            groups["model"] = g
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(dp)])
        if m == rank % model:
            groups["dp"] = g
    if rank == 0:
        print(f"mesh: dp={dp} model={model} backend={backend} devices="
              f"{[str(d) for d in devices]}", flush=True)
    return Mesh(dp, model, rank, device, backend, groups)


# --------------------------------------------------------------- spawn --
def _rank_main(rank: int, fn, dp: int, model: int, devices, store: str,
               args: tuple) -> None:
    if devices[rank].type == "cpu":
        # one thread per rank: the ranks share the machine's cores
        torch.set_num_threads(1)
    mesh = make_mesh(dp, model, devices, rank=rank,
                     init_method=f"file://{store}/store")
    try:
        out = fn(mesh, *args)
        torch.save(out, os.path.join(store, f"rank{rank}.pt"))
    finally:
        mesh.close()


def spawn(fn, dp: int, model: int = 1, devices: Optional[Sequence] = None,
          args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` on dp × model ranks, one process each
    (``torch.multiprocessing``, spawn start method), on a file store in a
    temporary directory → every rank's result, in rank order (results of
    plain dicts, lists, numbers, strings and tensors). ``devices`` as in
    ``make_mesh`` (default: rank r on card r mod the card count; raises
    without a card, ``["cpu"] * n`` runs on the CPU); ``fn`` must be
    importable. A rank that raises fails the call and ends the others."""
    import torch.multiprocessing as mp

    n = dp * model
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{r % torch.cuda.device_count()}" for r in range(n)]
    devices = [torch.device(d) for d in devices]
    with tempfile.TemporaryDirectory() as store:
        mp.spawn(_rank_main, args=(fn, dp, model, devices, store, args),
                 nprocs=n, join=True)
        return [torch.load(os.path.join(store, f"rank{r}.pt"),
                           map_location="cpu", weights_only=True)
                for r in range(n)]


"""The mesh of the port: a ``torch.distributed`` process group, one rank a
card, every rank running the same program.

Port of ``deepcalcium_tpu.parallel.mesh``. Where the JAX package hands GSPMD
one global array and a sharding, every rank here holds the whole host batch
and takes its own slice of dim 0 (:func:`shard_batch`); what GSPMD inserted
by itself is written out where it is needed:

- training: batch-norm statistics, loss sums and metrics over the global
  batch (:func:`psum`, differentiable), and one all-reduce of the gradients;
- evaluation: each rank runs its part of a slab and :func:`all_gather`
  returns the whole slab on every rank;
- movie reduction: each rank folds its range of the time axis
  (``ops.summary.movie_summary_sharded``).

NCCL carries the collectives on cards, gloo on the CPU. Nothing here forms a
group: ``parallel.distributed.initialize`` does, once a process.

``batch_sharding``, ``replicated`` and ``P`` of the JAX module describe
layouts to a compiler; eager PyTorch has no counterpart, and they are not
ported.
"""

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "get_mesh", "check_mesh", "shard_batch", "pad_batch_to",
           "LocalShard", "local_shard", "psum", "all_gather", "agree"]


class Mesh:
    """A process group and this process's place in it.

    # Attributes
        group: the ``torch.distributed`` group (None is the default one).
        rank, size: this process's rank in the group, and its ranks.
        device: where this rank's tensors live: the current card under
            NCCL, the CPU under gloo.
    """

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "no process group: call "
                "deepcalcium_torch.parallel.distributed.initialize() first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        if self.rank < 0:
            raise RuntimeError("this process is not a rank of the mesh's "
                               "group")
        if dist.get_backend(group) == "nccl":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device("cpu")

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device})")

    def barrier(self):
        """Every rank waits here for every other."""
        agree(self, 0)


def get_mesh(n_devices: int | None = None) -> Mesh:
    """The mesh over the initialised default group, or over its first
    ``n_devices`` ranks. The latter makes a new group, which is a collective
    of the whole default group: every rank calls it, once, and keeps the
    result; a rank outside the first ``n_devices`` then gets a RuntimeError.
    """
    if n_devices is None:
        return Mesh()
    world = dist.get_world_size()
    if not 1 <= n_devices <= world:
        raise ValueError(f"n_devices={n_devices} outside [1, {world}]")
    if n_devices == world:
        return Mesh()
    return Mesh(dist.new_group(list(range(n_devices))))


def check_mesh(mesh):
    """``mesh`` if it is None or a :class:`Mesh`; a TypeError otherwise."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a deepcalcium_torch.parallel.mesh.Mesh or None, "
            f"got {type(mesh).__name__} (multi-device runs take the mesh of "
            f"a torch.distributed group, see parallel.distributed)")
    return mesh


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class LocalShard(torch.Tensor):
    """A tensor that holds only this rank's part of a global batch. The
    train step takes it as it is, where it would slice a plain tensor."""


def local_shard(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of ``x`` as a plain tensor: ``x`` itself when it is
    marked as a :class:`LocalShard`, else its slice."""
    if isinstance(x, LocalShard):
        return x.as_subclass(torch.Tensor)
    return shard_batch(mesh, x)


def shard_batch(mesh: Mesh, batch):
    """This rank's slice of dim 0 of every leaf of ``batch`` (a tensor, an
    array, or a tuple, list or dict of them), which every rank holds whole.
    A 0-d leaf is kept whole. A dim 0 that ``mesh.size`` does not divide
    raises, as GSPMD refuses such a sharding."""

    def take(x):
        if np.ndim(x) == 0:
            return x
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f"batch of {n} does not divide over the "
                             f"mesh's {mesh.size} ranks")
        per = n // mesh.size
        return x[mesh.rank * per:(mesh.rank + 1) * per]

    return _tree_map(take, batch)


def pad_batch_to(batch_np, multiple: int):
    """Zero-pad dim 0 to a multiple (so B divides the mesh); returns
    (padded, true_size)."""
    b = batch_np.shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return batch_np, b
    widths = [(0, pad)] + [(0, 0)] * (batch_np.ndim - 1)
    return np.pad(batch_np, widths), b


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x, on every rank; its adjoint sums the ranks'
    gradients of y."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, on every rank, and
    differentiable.

    Every rank then holds the same value and, in a train step, derives the
    same replicated loss ``L`` from it. Backward on every rank at once
    therefore differentiates ``mesh.size`` copies of ``L``: a rank's
    ``.grad`` is ``mesh.size`` times its own data's share of dL/dw. Summed
    over the ranks and divided by ``mesh.size`` it is dL/dw
    (``train.trainer.make_train_step``)."""
    return _AllReduceSum.apply(x, mesh.group)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' ``x`` (same shape and dtype on each) concatenated along
    dim 0 in rank order, on every rank. Not differentiable."""
    x = x.detach().contiguous()
    out = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.chunk(mesh.size)), x, group=mesh.group)
    return out


def agree(mesh: Mesh, value: int) -> int:
    """The largest of the ranks' ``value`` (an int), on every rank: how the
    ranks settle on one timestamp, and a barrier."""
    t = torch.tensor([int(value)], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(t.item())

"""Forming and leaving the process group, and feeding it from local data.

Port of ``deepcalcium_tpu.parallel.distributed``. Every rank is one process
that runs the same program, as under ``jax.distributed``; start N of them
with ``torchrun --nproc-per-node N script.py`` (which sets ``RANK``,
``WORLD_SIZE`` and ``MASTER_ADDR``), or by hand and give each
``initialize("host:port", N, rank)``. Call :func:`initialize` once a
process before any multi-device call, build the mesh with :func:`pod_mesh`,
and call :func:`shutdown` at the end so that no process hangs at exit.

A single process may call all three as well: the group then has one rank,
and the same script runs unchanged on one card and on many.
"""

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from deepcalcium_torch.parallel.mesh import LocalShard, Mesh, _tree_map

__all__ = ["initialize", "shutdown", "pod_mesh", "global_batch_from_local",
           "LocalShard"]

logger = logging.getLogger(__name__)


def _backend(backend, device):
    if backend is not None:
        return backend
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device=None) -> None:
    """Form the default process group.

    # Arguments
        coordinator_address: ``"host:port"`` of rank 0 (a leading
            ``tcp://`` is accepted), with ``num_processes`` and
            ``process_id``. With all three None: return if a group exists;
            else take ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` from the
            environment where they are set (torchrun); else form a group of
            one rank on a free local port, with a warning.
        backend: "nccl" or "gloo". None picks NCCL for a CUDA ``device``
            and gloo for the CPU; ``device`` None means the card where
            there is one. Nothing falls back from NCCL to gloo. Under NCCL
            this process's current card becomes ``device``'s, or card
            ``LOCAL_RANK`` or ``process_id`` where it sees several.
    """
    backend = _backend(backend, device)
    if (coordinator_address is None and num_processes is None
            and process_id is None):
        if dist.is_initialized():
            return
        if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
            _pick_card(backend, device, int(os.environ["RANK"]))
            dist.init_process_group(backend, init_method="env://")
            logger.info("process group from the environment: rank %d of %d "
                        "(%s)", dist.get_rank(), dist.get_world_size(), backend)
            return
        # WARNING, not info: among several processes that were meant to
        # form one group, each would train alone and no gradient would ever
        # cross. One process on one card sees one benign warning.
        logger.warning(
            "no coordinator given and no RANK/WORLD_SIZE/MASTER_ADDR in the "
            "environment: forming a group of ONE rank. If this is one of "
            "several processes, they will NOT synchronise; start them with "
            "torchrun or pass coordinator_address, num_processes and "
            "process_id.")
        coordinator_address, num_processes, process_id = (
            f"127.0.0.1:{_free_port()}", 1, 0)
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("coordinator_address, num_processes and process_id "
                         "go together: pass all three or none")
    address = str(coordinator_address)
    if "://" not in address:
        address = f"tcp://{address}"
    _pick_card(backend, device, int(process_id))
    dist.init_process_group(backend, init_method=address,
                            world_size=int(num_processes),
                            rank=int(process_id))


def _pick_card(backend, device, rank):
    """Under NCCL one rank is one card: ``device``'s when it names one,
    else card ``LOCAL_RANK`` (torchrun) or ``rank``, modulo the cards this
    process sees. A process that sees one card keeps it."""
    if backend != "nccl":
        return
    from deepcalcium_torch.utils.device import require_cuda

    require_cuda()
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.index is not None:
        torch.cuda.set_device(dev)
    elif torch.cuda.device_count() > 1:
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shutdown() -> None:
    """Leave the default group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def pod_mesh() -> Mesh:
    """The mesh over the whole default group."""
    return Mesh()


def global_batch_from_local(mesh: Mesh, batch):
    """Mark each rank's LOCAL data as its shard of the global batch: every
    rank passes only its own rows (a tensor, an array, or a tuple, list or
    dict of them), they are copied to ``mesh.device``, and the train step
    does not slice them again. The global batch is the concatenation of the
    ranks' rows in rank order; every rank must pass the same number of
    rows, as the global statistics weigh the ranks alike."""

    def put(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        return t.to(mesh.device).as_subclass(LocalShard)

    return _tree_map(put, batch)

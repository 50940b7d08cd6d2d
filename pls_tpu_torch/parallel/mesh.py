"""The ('rows', 'folds') mesh on torch.distributed, and multi-process bring-up.

Counterpart of `pls_tpu/parallel/mesh.py:21-98`.  A device of the JAX mesh
is a rank here: one process on one device, laid out as
`np.asarray(devices).reshape(rows, folds)` lays the devices out, so
rank = row·folds + fold.
  'rows'  — data parallelism over observations: a rank holds a block of the
            rows of X and Y, and XᵀY, XᵀX, Xᵀt and tᵀt are sums over the
            ranks of its 'rows' group, those that share its fold index;
  'folds' — CV folds and replicates split over the ranks of a 'folds'
            group, those that share its row index; they never communicate
            until their errors are gathered.

The one collective is the sum all-reduce (`PLSMesh.psum`), the JAX code's
`psum`.  What the JAX package gathers through an out spec (T's
P('rows', None), the fold-sharded errors) is a sum of zero-padded blocks
(parallel/sharded.py): uneven blocks need nothing more, gloo sums CUDA
tensors where it has no all-gather for them, and a reader audits one kind
of call.  The backend is NCCL on the card and gloo on the CPU; gloo also
sums CUDA tensors, which lets two ranks share one card, as NCCL does not.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from pls_tpu_torch.config import default_device


@dataclass(frozen=True)
class PLSMesh:
    """This rank's place in the ('rows', 'folds') mesh: the axis sizes, its
    global rank, its device, and per axis the process group of the ranks on
    its line along that axis."""

    rows: int
    folds: int
    rank: int
    device: torch.device
    groups: dict = field(repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {"rows": self.rows, "folds": self.folds}

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return self.rank // self.folds if axis == "rows" else self.rank % self.folds

    def group(self, axis: str):
        """The process group of the ranks that share this rank's
        coordinate on the other axis."""
        return self.groups[axis]

    def psum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """t summed over this rank's `axis` group: the same tensor on every
        rank of the group."""
        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group(axis))
        return t


def rank_device(rank: int) -> torch.device:
    """The card of a rank on this host, `cuda:<rank mod cards>`: RuntimeError
    without a card (`config.default_device`)."""
    default_device()
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_pls_mesh(rows: int | None = None, folds: int = 1, *, device=None) -> PLSMesh:
    """The ('rows', 'folds') mesh over the ranks of the initialised process
    group (`initialize_distributed`).  If `rows` is None, it is inferred as
    world size // folds.  `device` is this rank's device: None is its card
    (`rank_device`; RuntimeError without one), "cpu" asks for the CPU.

    Every rank must call this, with the same arguments: it creates each
    axis's groups with `dist.new_group`, in the same order on every rank."""
    if not dist.is_initialized():
        raise RuntimeError("make_pls_mesh: no process group; call initialize_distributed first")
    n = dist.get_world_size()
    if rows is None:
        if n % folds:
            raise ValueError(f"{n} devices not divisible by folds={folds}")
        rows = n // folds
    if rows * folds != n:
        raise ValueError(f"rows*folds = {rows * folds} != {n} devices")
    rank = dist.get_rank()
    grid = np.arange(n).reshape(rows, folds)
    groups = {}
    for axis, lines in (("rows", grid.T), ("folds", grid)):
        for line in lines:
            group = dist.new_group(line.tolist())
            if rank in line:
                groups[axis] = group
    device = rank_device(rank) if device is None else torch.device(device)
    return PLSMesh(rows, folds, rank, device, groups)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    retries: int = 3,
    retry_delay_sec: float = 5.0,
    device=None,
    timeout_sec: float = 600.0,
) -> None:
    """Multi-process bring-up: `torch.distributed.init_process_group` with
    bounded retry (`pls_tpu/parallel/mesh.py:42-98`).

    `coordinator_address` is "host:port" (TCP, rank 0 serving the store),
    or a URL torch takes ("tcp://…", "file://…"); None, with the other two
    None, reads torch's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK).  The backend is NCCL on this rank's card (`device`, else
    `rank_device` of its rank; it becomes the current device) and gloo for
    device="cpu"; without a card
    and without device="cpu" this raises, as `config.default_device` does.
    A process group already initialised is a silent no-op.  A failure to
    reach the coordinator (ranks racing its start) is retried `retries`
    times, `retry_delay_sec` apart, then raised: the run fails loudly
    rather than going on as one process.  Collectives time out after
    `timeout_sec`, so a rank that dies fails the others instead of hanging
    them."""
    if dist.is_initialized():
        return
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    dev = rank_device(rank) if device is None else torch.device(device)
    backend = "gloo" if dev.type == "cpu" else "nccl"
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None else rank_device(rank))
    init = coordinator_address
    if init is not None and "://" not in init:
        init = f"tcp://{init}"
    kw = {"init_method": init, "timeout": timedelta(seconds=timeout_sec)}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    last: Exception | None = None
    for attempt in range(retries + 1):
        try:
            dist.init_process_group(backend, **kw)
            return
        except RuntimeError as e:
            if dist.is_initialized():  # another thread's initialisation won
                return
            last = e
            if attempt < retries:
                time.sleep(retry_delay_sec)
    raise RuntimeError(
        f"torch.distributed.init_process_group failed after {retries + 1} attempts "
        f"(coordinator={coordinator_address})"
    ) from last

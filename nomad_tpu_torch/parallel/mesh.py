"""Process groups and device meshes (counterpart of
``nomad_tpu.parallel.mesh``).

The JAX package annotates shardings over the devices of one process and
lets XLA place the collectives. The port runs one process (rank) per card
over ``torch.distributed``, NCCL for ``cuda`` and gloo for ``cpu``, in SPMD
order: every rank makes the same calls on the same inputs, and the
collectives are placed by hand. The meshes keep the JAX package's axis
names:

  * ``data_mesh(n=None)``: a 1-D ``DeviceMesh``, axis ``"data"``: batch
    data parallelism (the engine's and the trainer's).
  * ``grid_mesh(rows, cols)``: 2-D, axes ``("row", "col")``: the distance
    matrix of large-scale scoring.
  * ``pad_to_multiple`` as in the JAX package; ``sharded_cdist`` returns
    this rank's block of the matrix, ``gather_blocks`` the whole of it.

A mesh spans the whole process group: ``data_mesh(n)`` and ``grid_mesh``
refuse a world of another size, where the JAX package takes the first
devices of its process (a rank outside the mesh would have no part in
the SPMD order). Start the group with the mesh's size instead.

The JAX package's sharding objects mean nothing in a program of one
process per card. Each is replaced by the function that does its job:

  * ``batch_sharding(mesh)`` (dim 0 split over "data") ->
    ``rank_rows(n, mesh)``: this rank's row range of a batch of n rows;
  * ``shard_batch(x, mesh)`` (a host batch put with that sharding) ->
    ``shard_rows(x, mesh)``: this rank's rows of a host batch, taken before
    the copy to the device; ``gather_rows`` all-gathers them back;
  * ``replicated(mesh)`` (the same array on every device) ->
    ``replicate(tensors, mesh)``: rank 0's values broadcast to every rank,
    in place.

``init_process_group`` starts a rank's group and ``launch`` runs a function
on n ranks of this machine. Every wait is bounded: the group's collectives
time out after ``TIMEOUT_S`` and ``launch`` kills its ranks and raises
after its own timeout. Asking for more ranks than there are cards raises;
nothing falls back to the CPU.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops.distance import cdist, cdist_center

TIMEOUT_S = 60.0  # a collective that waits longer raises
LAUNCH_TIMEOUT_S = 300.0  # launch's default bound on its ranks


def backend_for(device_type: str) -> str:
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"device type {device_type!r} not supported: expected 'cuda' or 'cpu'")


def check_cards(n: int, device_type: str) -> None:
    """Raise unless n ranks of ``device_type`` can run here: one card a rank
    for ``cuda``."""
    backend_for(device_type)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the ranks run on the card and do not fall back to "
                "the CPU; pass device_type='cpu' to run there")
        if n > torch.cuda.device_count():
            raise RuntimeError(
                f"{n} ranks need {n} CUDA cards; this machine has {torch.cuda.device_count()}")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(rank: int, world_size: int, device_type: str = "cuda",
                       init_method: Optional[str] = None) -> None:
    """Start this rank's process group: NCCL on its card (``cuda:<local
    rank>``, ``LOCAL_RANK`` or else the rank) or gloo on the CPU.
    ``init_method``: ``tcp://host:port`` or ``file://path``; None takes
    ``env://`` when ``MASTER_ADDR`` is set (torchrun) and a free local port
    for a world of one, and raises otherwise."""
    check_cards(world_size, device_type)
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world_size == 1:
            init_method = f"tcp://localhost:{_free_port()}"
        else:
            raise ValueError(
                f"a world of {world_size} needs init_method (tcp://host:port or file://path) "
                "or MASTER_ADDR in the environment")
    kwargs = {}
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend_for(device_type), init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S), **kwargs)


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn, args, rank, world_size, device_type, init_method, threads, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_process_group(rank, world_size, device_type, init_method)
        try:
            out = fn(*args)
        finally:
            destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def launch(fn: Callable, n: int, device_type: str = "cuda", args: Sequence = (),
           timeout_s: float = LAUNCH_TIMEOUT_S, threads: Optional[int] = None) -> list:
    """Run ``fn(*args)`` on n fresh ranks of this machine (spawned
    processes, each in a process group of world size n; rank r on card r
    for ``cuda``) and return their results, rank 0 first. ``fn`` and its
    arguments and results must pickle, and ``fn`` must be importable by
    name (a module's top-level function). The ranks meet through a file
    under a temporary directory, so concurrent launches never contend for
    a port. A rank that raises, dies or outlasts ``timeout_s`` raises here,
    after every rank is killed. ``threads``: each rank's intra-op threads
    (the CPU's ranks share its cores)."""
    check_cards(n, device_type)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="nomad_ranks_") as tmp:
        init_method = f"file://{os.path.join(tmp, 'store')}"
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, tuple(args), r, n, device_type, init_method, threads,
                                   results))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            out = _collect(procs, results, n, time.monotonic() + timeout_s, timeout_s)
            for p in procs:
                p.join(timeout=TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return out


def _collect(procs, results, n: int, deadline: float, timeout_s: float) -> list:
    out: dict = {}
    while len(out) < n:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"ranks {sorted(set(range(n)) - set(out))} of {n} did not "
                               f"finish within {timeout_s} s; killed")
        try:
            rank, ok, value = results.get(timeout=min(1.0, left))
        except queue_mod.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in out and p.exitcode is not None]
            if dead:
                # a rank that exited without a result (killed, or crashed in C)
                time.sleep(0.5)
                if results.empty():
                    raise RuntimeError(
                        f"rank {dead[0]} of {n} died with exit code "
                        f"{procs[dead[0]].exitcode} and no result") from None
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
        out[rank] = value
    return [out[r] for r in range(n)]


# ---------------- meshes ----------------


def world_size() -> int:
    """The process group's size; 1 when none is running."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _group_world() -> tuple[int, str]:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group is running: start one with parallel.init_process_group, or run "
            "the ranks through parallel.launch")
    return dist.get_world_size(), "cuda" if dist.get_backend() == "nccl" else "cpu"


def data_mesh(n: Optional[int] = None):
    """1-D mesh over the process group: axis ``"data"``. n, when given,
    must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    world, device_type = _group_world()
    n = world if n is None else int(n)
    if n != world:
        raise ValueError(
            f"data_mesh({n}) in a process group of {world}: a mesh spans the whole group "
            f"(start the group with {n} ranks)")
    return init_device_mesh(device_type, (n,), mesh_dim_names=("data",))


def grid_mesh(rows: int, cols: int):
    """2-D mesh for distance-matrix sharding: axes ``("row", "col")``, rank
    r * cols + c at (r, c)."""
    from torch.distributed.device_mesh import init_device_mesh

    world, device_type = _group_world()
    if world < rows * cols:
        raise ValueError(f"need {rows * cols} devices, have {world}")
    if world != rows * cols:
        raise ValueError(
            f"a {rows} x {cols} grid in a process group of {world}: a mesh spans the whole "
            f"group (start the group with {rows * cols} ranks)")
    return init_device_mesh(device_type, (rows, cols), mesh_dim_names=("row", "col"))


def mesh_device(mesh) -> torch.device:
    """This rank's device in the mesh: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def device_for(mesh, device=None) -> torch.device:
    """The mesh's device for this rank; a ``device`` that names another
    raises (the mesh is not overridden silently)."""
    own = mesh_device(mesh)
    if device is not None:
        asked = torch.device(device)
        if asked.type == "cuda" and asked.index is None and torch.cuda.is_available():
            asked = torch.device("cuda", torch.cuda.current_device())
        if asked != own:
            raise ValueError(f"device {str(asked)!r} disagrees with the mesh: this rank runs "
                             f"on {str(own)!r}")
    return own


def is_main(mesh) -> bool:
    """True without a mesh, and on the process group's rank 0."""
    return mesh is None or dist.get_rank() == 0


def barrier(mesh) -> None:
    if mesh is not None:
        dist.barrier(group=mesh.get_group())


def _axis(mesh, axis: str) -> tuple[int, int]:
    """(size, this rank's coordinate) of a mesh axis."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.size(dim), mesh.get_local_rank(axis)


def rank_rows(n: int, mesh, axis: str = "data") -> slice:
    """This rank's rows of a batch of n rows split over ``axis`` (the job of
    the JAX package's ``batch_sharding``)."""
    size, r = _axis(mesh, axis)
    if n % size:
        raise ValueError(f"a batch of {n} rows does not split over the {size} ranks of axis "
                         f"{axis!r}: make it a multiple of {size}")
    s = n // size
    return slice(r * s, (r + 1) * s)


def shard_rows(x, mesh, axis: str = "data"):
    """This rank's rows of a host batch (an array or tensor, dim 0), or x
    itself without a mesh (the job of ``shard_batch``)."""
    if mesh is None:
        return x
    return x[rank_rows(len(x), mesh, axis)]


def gather_rows(t: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) stacked along dim 0 in the axis's
    order: the inverse of ``shard_rows``."""
    size, _ = _axis(mesh, axis)
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group(axis))
    return torch.cat(parts)


@torch.no_grad()
def replicate(tensors, mesh) -> None:
    """Rank 0's values of ``tensors`` on every rank of a 1-D mesh, in place
    (the job of ``replicated``)."""
    group = mesh.get_group()
    src = dist.get_global_rank(group, 0)
    for t in tensors:
        dist.broadcast(t, src=src, group=group)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _grid_coords(mesh) -> tuple[int, int, int, int]:
    rows, r = _axis(mesh, "row")
    cols, c = _axis(mesh, "col")
    return rows, cols, r, c


def sharded_cdist(a, b, mesh) -> torch.Tensor:
    """This rank's block of the distance matrix of a [N, D] and b [M, D]:
    rows (r N/R ...) of a, columns (c M/C ...) of b on the ``("row",
    "col")`` grid, on this rank's device. Every rank holds a and b whole;
    N and M are multiples of the grid's sides (the caller pads, as in the
    JAX package). The centre is the whole arrays' (``cdist``'s), so each
    block is the dense matrix's block, as XLA computes the sharded one."""
    rows, cols, r, c = _grid_coords(mesh)
    dev = mesh_device(mesh)
    a = torch.as_tensor(a).to(device=dev, dtype=torch.float32)
    b = torch.as_tensor(b).to(device=dev, dtype=torch.float32)
    if a.shape[0] % rows or b.shape[0] % cols:
        raise ValueError(f"[{a.shape[0]}, {b.shape[0]}] is not a multiple of the "
                         f"{rows} x {cols} grid: pad with pad_to_multiple")
    rn, cm = a.shape[0] // rows, b.shape[0] // cols
    return cdist(a[r * rn:(r + 1) * rn], b[c * cm:(c + 1) * cm], center=cdist_center(a, b))


def gather_blocks(block: torch.Tensor, mesh) -> torch.Tensor:
    """The whole [N, M] matrix on every rank from each rank's block of a
    ``grid_mesh``."""
    rows, cols, _, _ = _grid_coords(mesh)
    parts = [torch.empty_like(block) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, block.contiguous())
    at = mesh.mesh.tolist()  # the global rank at each (row, col)
    return torch.cat([torch.cat([parts[at[i][j]] for j in range(cols)], dim=1)
                      for i in range(rows)])

"""Process meshes, the rank launcher and the collectives of multi-GPU GP
inference.

Counterpart of ``gaussianprocessfundamentals_tpu/parallel/meshes.py``
(``make_mesh`` ``:27``, ``single_axis_mesh`` ``:40``, ``row_sharding``
``:46``, ``replicated`` ``:51``, ``init_multihost`` ``:55``). The JAX
package runs one controller over a device ``Mesh`` and lets XLA insert the
collectives. The port is SPMD: one process per rank, each holding plain
local tensors and calling ``torch.distributed`` itself, so every message is
visible in the code. The mesh has the JAX package's two axes:

* ``"dp"``: independent problems (restarts, MCMC chains);
* ``"tp"``: rows of the covariance; each rank owns an n/P row panel.

:class:`Mesh` is a thin class over ``torch.distributed``: one process group
per line of each axis and this rank's coordinates. It does not use
``DeviceMesh``, whose ``cuda`` meshes make NCCL groups: NCCL refuses two
ranks on one GPU, and the one-card layout runs P gloo ranks on it. The
backend is always the caller's, never detected or swapped:

* ``"nccl"``: one rank per GPU (more ranks than visible GPUs raises);
* ``"gloo"`` on the CPU;
* ``"gloo"`` with CUDA tensors, for P ranks sharing one GPU (its
  all-reduce, all-gather and broadcast stage through the host).

:func:`launch` spawns the ranks of one host (``torch.multiprocessing`` in
``spawn`` mode: forked children cannot initialise CUDA); under ``torchrun``
:func:`init_multihost` joins the group through ``env://``. Replicated
arrays (x, the CG state, parameters) are computed identically on every
rank; row panels are each rank's slice of the rows zero-padded to a
multiple of the axis size (:func:`row_range`).
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import queue as queue_mod
import socket
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    _sorted_leaves,
    _sorted_unflatten,
    tree_map,
)

BACKENDS = ("gloo", "nccl")


class Mesh:
    """A logical mesh over the ranks of the default process group: axis
    names and sizes (``shape``, row-major over the ranks, as
    ``mesh_utils.create_device_mesh``), this rank's coordinate on each
    axis, and one process group per axis holding the ranks that share the
    other coordinates. Every rank must build the same meshes in the same
    order (group creation is collective)."""

    def __init__(self, shape: dict):
        if not dist.is_initialized():
            raise RuntimeError(
                "Mesh: no process group; start the ranks with "
                "parallel.meshes.launch, or under torchrun call "
                "init_multihost() first")
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        sizes = [self.shape[a] for a in self.axis_names]
        if math.prod(sizes) != self.world:
            raise ValueError(f"mesh {self.shape} != {self.world} ranks")
        strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
        self.coords = {a: (self.rank // s) % n
                       for a, s, n in zip(self.axis_names, strides, sizes)}
        self._groups = {}
        for a, s, n in zip(self.axis_names, strides, sizes):
            if n == self.world:
                self._groups[a] = (dist.group.WORLD, list(range(n)))
                continue
            # every line along axis a: the ranks that differ only in it
            bases = sorted({r - ((r // s) % n) * s for r in range(self.world)})
            for b in bases:
                ranks = [b + i * s for i in range(n)]
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[a] = (g, ranks)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.coords[axis]

    def group(self, axis: str):
        return self._groups[axis][0]

    def global_rank(self, axis: str, index: int) -> int:
        """The global rank at coordinate ``index`` of ``axis`` on this
        rank's line."""
        return self._groups[axis][1][index]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}/{self.world}, "
                f"{self.backend})")


def make_mesh(dp: int = 1, tp: Optional[int] = None) -> Mesh:
    """A (dp × tp) mesh over all ranks; tp defaults to the ranks left."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp is None:
        if world % dp:
            raise ValueError(f"{world} ranks not divisible by dp={dp}")
        tp = world // dp
    return Mesh({"dp": dp, "tp": tp})


def single_axis_mesh(name: str = "tp") -> Mesh:
    """A one-axis mesh over all ranks."""
    return Mesh({name: dist.get_world_size() if dist.is_initialized() else 1})


def row_sharding(mesh: Mesh, axis: str = "tp"):
    """The placement of [n, ...] arrays sharded along covariance rows:
    ``Shard(0)`` over ``axis`` (the rank holds :func:`row_range`). It and
    :func:`replicated` keep the JAX package's names; the port's paths slice
    their rows with :func:`row_range` and call neither."""
    from torch.distributed.tensor import Shard

    del mesh, axis
    return Shard(0)


def replicated(mesh: Mesh):
    """The placement of arrays every rank holds whole."""
    from torch.distributed.tensor import Replicate

    del mesh
    return Replicate()


# --- launching ranks -------------------------------------------------------

def check_backend(backend: str, device: str, ranks: int) -> None:
    """Refuse a layout the backend cannot run: NCCL needs CUDA and one GPU
    per rank (it refuses two ranks on one GPU)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: 'cpu' or 'cuda'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is false")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("backend='nccl' needs device='cuda'")
        if ranks > torch.cuda.device_count():
            raise ValueError(
                f"backend='nccl' with {ranks} ranks on "
                f"{torch.cuda.device_count()} visible GPU(s): NCCL takes one "
                "rank per GPU; run P ranks on one GPU with backend='gloo'")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _rank_main(fn, rank, world, backend, device, init_method, timeout,
               threads, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        # plain pickle: the result's bytes travel in the message (torch's
        # queue would pass tensors as shared memory the exiting rank owns)
        results.put((rank, True, pickle.dumps(_to_host(out))))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))


def launch(fn: Callable, nprocs: int, args: Sequence = (), *,
           backend: str = "gloo", device: str = "cuda",
           timeout: float = 300.0, init_method: Optional[str] = None,
           threads: int = 0) -> list:
    """Run ``fn(*args)`` on ``nprocs`` spawned ranks of one host and return
    the ranks' results in rank order (tensors moved to the CPU).

    ``fn`` must be importable by the children (a module-level function of
    a module that can be imported without side effects); ``args`` are
    pickled. Each rank sets ``torch.cuda.set_device(rank % device_count)``
    for ``device="cuda"`` (the default, as the port's other entry points;
    pass ``"cpu"`` for CPU ranks), joins a process group of ``backend`` at
    ``init_method`` (default ``tcp://127.0.0.1:<free port>``) with
    ``timeout`` on every collective, and runs ``threads`` torch threads
    (0: torch's default). A rank that raises, dies or has not reported
    within ``timeout`` seconds ends every rank, and this raises: a dead
    rank would leave the others blocked in a collective.
    """
    check_backend(backend, device, nprocs)
    if init_method is None:
        init_method = f"tcp://127.0.0.1:{_free_port()}"
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nprocs, backend, device, init_method,
                               timeout, threads, tuple(args), results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(nprocs)) - set(got))
                raise TimeoutError(
                    f"launch: rank(s) {missing} of {nprocs} ({backend}, "
                    f"{device}) did not finish within {timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                for r, p in enumerate(procs):
                    if r not in got and p.exitcode not in (None, 0):
                        raise RuntimeError(
                            f"launch: rank {r} of {nprocs} died with exit "
                            f"code {p.exitcode} before reporting")
                continue
            if not ok:
                raise RuntimeError(
                    f"launch: rank {rank} of {nprocs} ({backend}, {device}) "
                    f"raised:\n{value}")
            got[rank] = pickle.loads(value)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
    return [got[r] for r in range(nprocs)]


def init_multihost(backend: str, device: str = "cuda",
                   timeout: float = 1800.0) -> None:
    """Join the process group of a ``torchrun`` launch (``env://``: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), one process per rank, possibly
    over several hosts; a no-op when a group exists or when the process was
    not started by a launcher. ``backend`` is the caller's ("nccl" or
    "gloo", as for :func:`launch`); with ``device="cuda"`` each rank takes
    GPU LOCAL_RANK, and NCCL with more ranks on this host than GPUs
    raises."""
    if dist.is_initialized() or "RANK" not in os.environ:
        return
    local = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", 1)))
    check_backend(backend, device, local_world)
    if device == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout))


# --- collectives -----------------------------------------------------------

def pad_to(a: torch.Tensor, rows: int) -> torch.Tensor:
    """``a`` with zero rows appended up to ``rows`` (``_pad_to``)."""
    pad = rows - a.shape[0]
    if pad <= 0:
        return a
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])


def row_range(n: int, mesh: Mesh, axis: str = "tp") -> tuple:
    """(start, stop, rows): this rank's slice of n rows padded to a
    multiple of the axis size; ``rows`` is every rank's panel height and
    [start, stop) the real rows in this rank's panel (empty past n)."""
    rows = -(-n // mesh.size(axis))
    start = min(mesh.index(axis) * rows, n)
    return start, min(start + rows, n), rows


def all_gather_rows(local: torch.Tensor, mesh: Mesh, axis: str = "tp"
                    ) -> torch.Tensor:
    """The axis's row panels (each [rows, ...]) concatenated in rank order.
    Not differentiable (see :class:`GatherRows`)."""
    parts = [torch.empty_like(local) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, local.contiguous(), group=mesh.group(axis))
    return torch.cat(parts)


def all_reduce_tree(tree, mesh: Mesh, axis: str = "tp", op=None):
    """A params tree summed (or reduced by ``op``) over the axis: its leaves
    travel as one flat buffer (dict keys sorted, so trees built in another
    insertion order line up), one collective."""
    leaves = _sorted_leaves(tree)
    if not leaves:
        return tree
    dt = leaves[0].dtype
    for leaf in leaves[1:]:
        dt = torch.promote_types(dt, leaf.dtype)
    flat = torch.cat([l.reshape(-1).to(dt) for l in leaves])
    dist.all_reduce(flat, op=op or dist.ReduceOp.SUM, group=mesh.group(axis))
    out, i = [], 0
    for leaf in leaves:
        out.append(flat[i:i + leaf.numel()].reshape(leaf.shape).to(leaf.dtype))
        i += leaf.numel()
    return _sorted_unflatten(tree, out)


def all_reduce_mean(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``t`` averaged over the axis (``lax.pmean``)."""
    t = t.clone()
    dist.all_reduce(t, group=mesh.group(axis))
    return t / mesh.size(axis)


def agree_any(flag: torch.Tensor, mesh: Mesh, axis: Optional[str] = None
              ) -> torch.Tensor:
    """A boolean that is true on every rank when it is true on any rank of
    the axis (all ranks when ``axis`` is None): one all-reduce(MAX), so a
    decision that controls a collective is taken the same way everywhere."""
    t = flag.to(torch.int32).reshape(1).clone()
    group = None if axis is None else mesh.group(axis)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t[0].bool().reshape(flag.shape)


def agree_all_done(mesh: Mesh):
    """The ``all_done`` of :func:`..linalg.mbcg.mbcg` under a mesh: CG stops
    when every column is done on every rank (one all-reduce per check)."""
    return lambda done: not bool(agree_any(~done.all(), mesh))


def broadcast_from(t: torch.Tensor, index: int, mesh: Mesh, axis: str = "tp"
                   ) -> torch.Tensor:
    """``t`` of the rank at coordinate ``index`` of the axis, on every rank
    of it (the others pass a buffer of the same shape)."""
    t = t.contiguous()
    dist.broadcast(t, src=mesh.global_rank(axis, index), group=mesh.group(axis))
    return t


class GatherRows(torch.autograd.Function):
    """All-gather of row panels that differentiates: the forward
    concatenates the axis's panels; the backward hands each rank the
    gradient rows of its own panel and nothing else. Every rank computes
    the same replicated loss from the gathered array, so summing the P
    copies of that gradient (what a reduce-scatter backward does) would
    count it P times. The panel's inputs that every rank shares (the
    hyperparameters) get their gradients summed over the ranks by
    :class:`SumGrads` instead."""

    @staticmethod
    def forward(ctx, local, mesh, axis):
        ctx.rows, ctx.index = local.shape[0], mesh.index(axis)
        return all_gather_rows(local, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        s = ctx.index * ctx.rows
        return grad[s:s + ctx.rows], None, None


class SumGrads(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the axis. Put
    on a replicated input before it builds a rank's row panel, so its
    gradient collects every panel's contribution."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.group(ctx.axis))
        return grad, None, None


def sum_grads_tree(tree, mesh: Mesh, axis: str = "tp"):
    """:class:`SumGrads` on every leaf that requires grad."""
    return tree_map(lambda t: SumGrads.apply(t, mesh, axis)
                    if torch.is_tensor(t) and t.requires_grad else t, tree)

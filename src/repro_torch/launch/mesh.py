"""The client mesh on `torch.distributed` (port of `repro.launch.mesh`).

The reference lays DRACO's clients over the mesh's "data" axis (or the
flattened ("pod", "data") product) and each client's model over
"model" (tensor parallelism by GSPMD). The port lays the client axis
over ranks: a world of R ranks and N clients gives each rank N / R
clients, and the mesh steps (`repro_torch.launch.steps`, the sharded
drain, the ring mix, `simulate_sweep(mesh=)`) move rows between ranks
with the collectives of `Mesh`. A "model" axis larger than 1 needs
tensor parallelism written out by hand and raises `NotImplementedError`
(ROADMAP item 20).

Backends are explicit, never chosen for the caller and never fallen back
from: ``nccl`` runs one rank per card; ``gloo`` runs on the CPU, and
also lets several ranks share one card (NCCL refuses two ranks on one
device). Under gloo with CUDA tensors every collective stages through
the host: the tensor is copied to host memory, the collective runs there
and the result is copied back (`Mesh.staged`).

The process group comes first, from `init_world` (a file or TCP store,
or the environment ``torchrun`` sets), then the mesh over it. Defined as
functions, never module-level constants, so importing this module
touches no process group.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh-backend gloo ...
"""
from __future__ import annotations

import datetime
import math
import os
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

ROADMAP_MODEL_AXIS = "ROADMAP item 20"

# the collectives' current spellings (torch 2.13 deprecates the older ones)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def init_world(backend: str, *, world_size: Optional[int] = None, rank: Optional[int] = None,
               init_method: Optional[str] = None, timeout: float = 600.0) -> None:
    """Initialise the default process group once: from `init_method`
    (``file://...`` or ``tcp://localhost:<port>``) with `world_size` and
    `rank`, or from the environment ``torchrun`` sets when they are
    None. `timeout` (s) bounds every collective, so a hung peer fails
    the run instead of stalling it. On ``nccl`` the rank's card is
    selected first (local rank modulo the cards)."""
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"process group runs {dist.get_backend()}, not {backend}")
        return
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {} if init_method is None else dict(init_method=init_method, world_size=world_size,
                                             rank=rank)
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout), **kw)


def rank_device(backend: str, device=None) -> torch.device:
    """The rank's compute device: `device` when given; else its card
    (``cuda:<local rank modulo the cards>``, so ranks sharing one card
    all get ``cuda:0``)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if not torch.cuda.is_available():
        raise RuntimeError("the mesh runs on CUDA by default and no CUDA device is "
                           "available; pass device='cpu' to run on the CPU explicitly")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


COLLECTIVES = ("reduce_scatter", "all_gather", "broadcast", "ring_exchange")


class Mesh:
    """A named mesh over the ranks of the default process group.

    ``shape`` maps axis name to size and ``axis_names`` orders them, as
    a JAX mesh; ``device_mesh`` is the `DeviceMesh` underneath. The
    client axes (`client_axes`) form one process group, ``group``, of
    ``size`` ranks in which this rank is ``rank``; the collectives below
    run over it. ``collective_s`` accumulates the wall seconds spent in
    them (on CUDA each is bracketed by a device sync, so it times the
    collective and its staging, not the work queued before it).
    ``collective_bytes`` and ``collective_counts`` tally, per kind of
    `COLLECTIVES`, the bytes of each collective's result on this rank
    (what it receives, as the reference reads from its HLO) and the
    number of calls; `collective_tally` returns both in the reference's
    ``collective_bytes`` shape.

    `Mesh.dry` builds the same class without a process group: rank 0
    of a world that does not exist, for the dry run. Its
    collectives return results of the real shapes and dtypes, the rank's
    own share (its block of a reduce-scatter, its tensor repeated for an
    all-gather, copies for a broadcast or an exchange; on ``meta`` only
    their allocations, so the dry run's byte counter sees no stand-in
    traffic), and fill the tally; nothing is sent and no peer's data is
    in them."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *, backend: str,
                 device=None):
        from torch.distributed.device_mesh import init_device_mesh

        shape, axes = self._set_axes(shape, axes)
        if not dist.is_initialized():
            raise RuntimeError("no process group: call init_world(backend, ...) first")
        if dist.get_backend() != backend:
            raise ValueError(f"process group runs {dist.get_backend()}, not {backend}")
        if math.prod(shape) != dist.get_world_size():
            raise ValueError(f"mesh {self.shape} needs {math.prod(shape)} ranks, the world "
                             f"has {dist.get_world_size()}")
        self.backend = backend
        self.device = rank_device(backend, device)
        self.device_mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                                            mesh_dim_names=axes)
        caxes = client_axes(self)
        if len(caxes) == 1:
            self.group = self.device_mesh.get_group(caxes[0])
        else:  # the flattened ("pod", "data") product: every rank, as "model" is 1
            self.group = dist.new_group(self.device_mesh.mesh.flatten().tolist())
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.is_dry = False
        self.reset_tally()

    @classmethod
    def dry(cls, shape: Sequence[int], axes: Sequence[str], *, device="meta") -> "Mesh":
        """A world-less mesh of `shape` over `axes` standing for client
        rank 0 on `device` (see the class docstring); the same "model"
        axis check as a real mesh."""
        mesh = cls.__new__(cls)
        shape, _ = mesh._set_axes(shape, axes)
        mesh.size = math.prod(mesh.shape[a] for a in client_axes(mesh))
        mesh.backend, mesh.device, mesh.device_mesh, mesh.group = None, torch.device(device), \
            None, None
        mesh.rank, mesh.staged, mesh.is_dry = 0, False, True
        mesh.reset_tally()
        return mesh

    def _set_axes(self, shape, axes):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes
        wide = {a: s for a, s in self.shape.items() if a not in client_axes(self) and s > 1}
        if wide:
            raise NotImplementedError(
                f"mesh axes {wide} shard one model (tensor parallelism); only the "
                f"client axes {client_axes(self)} are laid over ranks so far "
                f"({ROADMAP_MODEL_AXIS})")
        return shape, axes

    def reset_tally(self) -> None:
        """Zero ``collective_s`` and the per-kind tally."""
        self.collective_s = 0.0
        self.collective_bytes = {k: 0 for k in COLLECTIVES}
        self.collective_counts = {k: 0 for k in COLLECTIVES}

    def collective_tally(self) -> dict:
        """``{kind: result bytes, ..., "_counts": {kind: calls}}`` since
        the mesh was made or `reset_tally`."""
        return {**self.collective_bytes, "_counts": dict(self.collective_counts)}

    def __repr__(self):
        world = "no world" if self.is_dry else f"backend={self.backend!r}"
        return (f"Mesh({self.shape}, {world}, device={self.device}, "
                f"client rank {self.rank} of {self.size})")

    # -- the rank's clients ----------------------------------------------

    def client_slice(self, n: int) -> slice:
        """This rank's rows of `n` clients: ``n / size`` in rank order.
        Raises `ValueError` when `n` does not divide by the client ranks."""
        if n % self.size:
            raise ValueError(f"client count {n} not divisible by the mesh's "
                             f"{self.size} client ranks")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def owner(self, client: int, n: int) -> int:
        """The client rank that holds client `client` of `n`."""
        return client // (n // self.size)

    # -- collectives over the client group -------------------------------

    def _run(self, kind: str, fn: Callable, local: Callable, *tensors):
        """`fn` on `tensors` (staged to the host under gloo with CUDA
        tensors), timed into ``collective_s`` and tallied under `kind`;
        returns `fn`'s tensors on the rank's device. A dry mesh runs
        `local`, the rank's share without peers, instead, untimed."""
        out = local(*tensors) if self.is_dry else self._timed(fn, tensors)
        self.collective_bytes[kind] += sum(t.numel() * t.element_size() for t in out)
        self.collective_counts[kind] += 1
        return out

    @staticmethod
    def _copy(t: torch.Tensor) -> torch.Tensor:
        """A dry mesh's stand-in result: a copy of `t`, its allocation
        alone on ``meta``."""
        if t.is_meta:
            return torch.empty_like(t, memory_format=torch.contiguous_format)
        return t.clone(memory_format=torch.contiguous_format)

    def _timed(self, fn: Callable, tensors):
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        if self.staged:
            tensors = tuple(t.cpu() for t in tensors)
        out = fn(*tensors)
        if self.staged:
            out = tuple(t.to(self.device) for t in out)
        if cuda:
            torch.cuda.synchronize(self.device)
        self.collective_s += time.perf_counter() - t0
        return out

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Sum `x` over the client ranks and keep this rank's `1 / size`
        of axis `dim` (its block of rows, in rank order)."""
        if x.shape[dim] % self.size:
            raise ValueError(f"axis {dim} of {tuple(x.shape)} does not divide by "
                             f"{self.size} ranks")

        def scatter(src):
            out = torch.empty((src.shape[0] // self.size,) + tuple(src.shape[1:]),
                              dtype=src.dtype, device=src.device)
            _REDUCE_SCATTER(out, src, group=self.group)
            return (out,)

        def local(src):
            k = src.shape[0] // self.size
            return (self._copy(src[self.rank * k:(self.rank + 1) * k]),)

        (out,) = self._run("reduce_scatter", scatter, local, x.movedim(dim, 0).contiguous())
        return out.movedim(0, dim).contiguous() if dim % x.dim() else out

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Concatenate every client rank's `x` along `dim`, in rank order."""
        def gather(src):
            out = torch.empty((src.shape[0] * self.size,) + tuple(src.shape[1:]),
                              dtype=src.dtype, device=src.device)
            _ALL_GATHER(out, src, group=self.group)
            return (out,)

        def local(src):
            if src.is_meta:
                return (src.new_empty((src.shape[0] * self.size,) + tuple(src.shape[1:])),)
            return (src.repeat((self.size,) + (1,) * (src.dim() - 1)),)

        (out,) = self._run("all_gather", gather, local, x.movedim(dim, 0).contiguous())
        return out.movedim(0, dim).contiguous() if dim % x.dim() else out

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Client rank `src`'s `x` on every rank (a new tensor; `x` gives
        the shape and dtype on the others)."""
        def bcast(t):
            t = t.contiguous().clone()
            dist.broadcast(t, src=dist.get_global_rank(self.group, src), group=self.group)
            return (t,)

        return self._run("broadcast", bcast, lambda t: (self._copy(t),), x)[0]

    def broadcast_tensors(self, tensors, src: int) -> list:
        """Client rank `src`'s `tensors` on every rank, bit for bit, in one
        broadcast of their packed bytes (`pack`); the others' `tensors`
        give the shapes and dtypes."""
        return unpack(self.broadcast(pack(tensors), src), tensors)

    def ring_exchange(self, to_next: torch.Tensor, to_prev: torch.Tensor):
        """Send `to_next` to client rank ``rank + 1`` and `to_prev` to
        ``rank - 1`` (cyclically) in one batch of point-to-point
        exchanges; returns ``(from_prev, from_next)``: what the previous
        rank sent forward and what the next rank sent back."""
        if self.size == 1:
            return to_next.clone(), to_prev.clone()

        def local(fwd, bwd):
            return self._copy(fwd), self._copy(bwd)

        def exchange(fwd, bwd):
            nxt = dist.get_global_rank(self.group, (self.rank + 1) % self.size)
            prv = dist.get_global_rank(self.group, (self.rank - 1) % self.size)
            fwd, bwd = fwd.contiguous(), bwd.contiguous()
            from_prev, from_next = torch.empty_like(fwd), torch.empty_like(bwd)
            ops = [dist.P2POp(dist.isend, fwd, nxt, self.group, tag=0),
                   dist.P2POp(dist.isend, bwd, prv, self.group, tag=1),
                   dist.P2POp(dist.irecv, from_prev, prv, self.group, tag=0),
                   dist.P2POp(dist.irecv, from_next, nxt, self.group, tag=1)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            return from_prev, from_next

        return self._run("ring_exchange", exchange, local, to_next, to_prev)

    def barrier(self) -> None:
        if not self.is_dry:
            dist.barrier(group=self.group)


def pack(tensors) -> torch.Tensor:
    """Tensors -> one uint8 buffer of their bytes, each padded to 8 so
    that `unpack` views every one aligned for its dtype (one collective
    moves tensors of mixed dtypes, bit for bit)."""
    parts = []
    for x in tensors:
        b = x.contiguous().reshape(-1).view(torch.uint8)
        parts += [b, b.new_zeros((-b.numel()) % 8)]
    return torch.cat(parts)


def unpack(buf: torch.Tensor, like) -> list:
    """Inverse of `pack`: views of `buf` shaped and typed as `like`."""
    out, off = [], 0
    for x in like:
        nbytes = x.numel() * x.element_size()
        out.append(buf[off:off + nbytes].view(x.dtype).reshape(x.shape))
        off += nbytes + (-nbytes) % 8
    return out


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, backend: str,
              device=None) -> Mesh:
    """A `Mesh` of `shape` over `axes` on the initialised world (see
    `init_world`); `device` is the rank's compute device (default: its
    card)."""
    return Mesh(shape, axes, backend=backend, device=device)


def make_production_mesh(*, multi_pod: bool = False, backend: str = "nccl", device=None):
    """The reference's production layout: (16, 16) over ("data", "model"),
    or (2, 16, 16) with "pod". Its 16-way "model" axis raises
    `NotImplementedError` (ROADMAP item 20)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, backend=backend, device=device)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), *, backend: str = "gloo",
                   device="cpu"):
    """A small mesh for CPU tests (needs prod(shape) ranks); the default
    (2, 2) has a "model" axis and raises, so tests pass (R, 1)."""
    return make_mesh(shape, axes, backend=backend, device=device)


def make_sweep_mesh(num_data: Optional[int] = None, *, backend: str, device=None):
    """Mesh for `repro_torch.api.sweep.simulate_sweep(..., mesh=...)`:
    every rank on "data", a trivial "model" axis. `num_data` defaults to
    the world size; the client count N must divide by it."""
    n = num_data if num_data is not None else dist.get_world_size()
    return make_mesh((n, 1), ("data", "model"), backend=backend, device=device)


def client_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def num_clients(mesh) -> int:
    n = 1
    for a in client_axes(mesh):
        n *= mesh.shape[a]
    return n


# ---------------------------------------------------------------------------
# A world of ranks on one machine
# ---------------------------------------------------------------------------


def _rank_main(rank, world, fn, args, backend, root, timeout, threads):
    if threads:
        torch.set_num_threads(threads)
    init_world(backend, world_size=world, rank=rank, init_method=f"file://{root}/store",
               timeout=timeout)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, *args, backend: str, timeout: float = 60.0,
                threads: int = 1, deadline: float = 900.0) -> list:
    """Run ``fn(rank, world, *args)`` in `world` fresh processes joined in
    one process group of `backend` (a file store in a temporary
    directory) and return their results in rank order (each saved with
    `torch.save` and loaded here). `fn` must be importable by name (a
    module-level function). `timeout` (s) bounds each collective,
    `deadline` (s) the whole world; `threads` > 0 sets each rank's torch
    threads (ranks share the machine's cores). A failing rank raises
    here with its traceback; every process is gone on return. Kernels a
    rank launches are built before (`repro_torch.kernels.build.build`),
    so that the ranks do not each run nvcc."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ranks-") as root:
        ctx = mp.start_processes(_rank_main, args=(world, fn, args, backend, root, timeout,
                                                   threads),
                                 nprocs=world, start_method="spawn", join=False)
        end = time.monotonic() + deadline
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > end:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} ran past "
                                       f"{deadline:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]

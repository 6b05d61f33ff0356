"""Device mesh and the collectives of the sharded paths (port of tpu3dm/parallel/mesh.py).

Axis conventions, as in JAX:

  - ``pair``: data parallelism over cloud pairs (many registrations in
    flight); a pair shard is computed once, on the first device of its row.
  - ``block``: the within-pair axis: hypothesis shards of RANSAC
    (sharded_ransac.py), point shards of the ring NN search (ring_nn.py)
    and of the sharded ICP (sharded_icp.py); computed on row 0.

A port mesh is an ``[n_pair, n_block]`` array of ``torch.device``s.  A device
may repeat: ``[torch.device("cpu")] * 8`` simulates eight devices on the
CPU, ``[cuda:0] * 4`` runs the real sharding on one card (the shard split,
the ring rotation, the ordered sums and the election), and distinct devices
put each shard on its own card.

JAX's collectives (``ppermute``, ``psum``, ``all_gather``) become plain
functions over a list of per-shard tensors, one entry per position of a
mesh line (``Line``): the ring shift moves each shard to the next position;
the ordered sum adds the shards in position order on one device, whatever
device holds a shard, so the same shards give the same bits on a simulated
mesh, across cards and across processes.

Across processes (``initialize_distributed``): ``make_mesh`` spans every
process's local devices in rank order, each process computes only the
shards on its own devices (an entry of a shard list is None elsewhere), and
the collectives exchange shards through ``torch.distributed``: point to
point for the ring shift, an all-gather of raw bytes for the rest, so every
process ends with the same bits.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

PAIR_AXIS = "pair"
BLOCK_AXIS = "block"


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
) -> None:
    """Join a multi-process run (a no-op for one process, as in JAX).

    ``coordinator`` is "host:port" of rank 0 (``tcp://`` is added); without
    it the rendezvous reads MASTER_ADDR / MASTER_PORT.  ``num_processes`` and
    ``process_id`` default from WORLD_SIZE and RANK.  ``backend`` defaults
    to "nccl" where CUDA is available, else "gloo" (CPU meshes).
    """
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    if coordinator is None:
        init_method = "env://"
    else:
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)


def _process() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """An ``[n_pair, n_block]`` array of devices, each owned by one process.

    ``shape`` is {"pair": n_pair, "block": n_block}, as a JAX mesh's.
    ``home`` is this process's first device: ordered sums and gathered
    outputs land there.
    """

    def __init__(self, devices: np.ndarray, ranks: np.ndarray, rank: int) -> None:
        if devices.ndim != 2 or devices.shape != ranks.shape:
            raise ValueError(f"mesh devices {devices.shape} and ranks {ranks.shape} must be 2-D")
        self.devices = devices
        self.ranks = ranks
        self.rank = rank
        self.shape = {PAIR_AXIS: devices.shape[0], BLOCK_AXIS: devices.shape[1]}
        mine = [d for d, r in zip(devices.flat, ranks.flat) if r == rank]
        # A process without a device of the mesh still joins its collectives.
        self.home = mine[0] if mine else torch.device("cpu")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"

    def line(self, axis: str) -> Line:
        """The devices along ``axis``: the pair axis on block column 0, the
        block axis on pair row 0 (the other rows and columns hold replicas,
        which JAX computes on every device and the port once)."""
        if axis == PAIR_AXIS:
            idx = [(p, 0) for p in range(self.shape[PAIR_AXIS])]
        elif axis == BLOCK_AXIS:
            idx = [(0, b) for b in range(self.shape[BLOCK_AXIS])]
        else:
            raise ValueError(f"mesh axis must be {PAIR_AXIS!r} or {BLOCK_AXIS!r}, got {axis!r}")
        return Line(self, [self.devices[i] for i in idx], [int(self.ranks[i]) for i in idx])


def make_mesh(
    n_pair: int | None = None,
    n_block: int | None = None,
    *,
    devices: list | None = None,
) -> Mesh:
    """Build a ``(pair, block)`` mesh over the available devices.

    Defaults, as JAX's: all devices on the pair axis (pure DP); one size
    given, the other divides the device count.  ``n_pair * n_block`` must
    equal the device count (ValueError).  ``devices`` are this process's
    devices (a device may repeat); None means every visible CUDA device and
    raises without CUDA.  In a multi-process run the mesh spans every
    process's devices in rank order.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass devices=[...] "
                               "(e.g. [torch.device('cpu')] * 8) for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [torch.device(d) for d in devices]
    rank, world = _process()
    if world > 1:
        everyone: list = [None] * world
        dist.all_gather_object(everyone, [str(d) for d in local])
        flat = [(torch.device(d), r) for r, ds in enumerate(everyone) for d in ds]
    else:
        flat = [(d, 0) for d in local]
    n = len(flat)
    if n_pair is None and n_block is None:
        n_pair, n_block = n, 1
    elif n_pair is None:
        n_pair = n // n_block
    elif n_block is None:
        n_block = n // n_pair
    if n_pair * n_block != n:
        raise ValueError(f"mesh {n_pair}x{n_block} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = [d for d, _ in flat]
    ranks = np.asarray([r for _, r in flat], dtype=np.int64)
    return Mesh(arr.reshape(n_pair, n_block), ranks.reshape(n_pair, n_block), rank)


def check_mesh(where: str, mesh) -> Mesh:
    """``mesh`` itself when it is a ``Mesh``; a TypeError otherwise."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{where}: mesh must be a tpu3dm_torch.parallel.mesh.Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    return mesh


class Line:
    """One axis of a mesh: ``n`` positions, each a device and its process.

    A shard list has one entry per position: the shard's tensor where this
    process owns the position, None elsewhere.  Every process of the mesh
    calls the collectives in the same order.  ``calls`` counts the calls of
    each of JAX's collectives (``shift``, ``psum``, ``all_gather``) over
    every line: the census of apps/benchmark.py's scaling model reads it.
    """

    calls = {"shift": 0, "psum": 0, "all_gather": 0}

    def __init__(self, mesh: Mesh, devices: list, ranks: list[int]) -> None:
        self.mesh = mesh
        self.devices = devices
        self.ranks = ranks
        self.n = len(devices)
        self.spans_processes = len(set(mesh.ranks.flat)) > 1

    def local(self) -> list[int]:
        """The positions this process computes."""
        return [i for i, r in enumerate(self.ranks) if r == self.mesh.rank]

    def split(self, x: torch.Tensor | None) -> list:
        """Cut ``x`` along axis 0 into n equal shards (ValueError unless n
        divides it), each copied to its position's device (a fresh tensor, so
        kernels get aligned rows); None stays None."""
        if x is None:
            return [None] * self.n
        if x.shape[0] % self.n:
            raise ValueError(f"axis 0 of size {x.shape[0]} does not split into {self.n} shards")
        size = x.shape[0] // self.n
        out: list = [None] * self.n
        for i in self.local():
            out[i] = x[i * size:(i + 1) * size].to(self.devices[i], copy=True)
        return out

    def replicate(self, x: torch.Tensor) -> list:
        """``x`` on every local position's device (``psum``'s broadcast)."""
        out: list = [None] * self.n
        for i in self.local():
            out[i] = x.to(self.devices[i])
        return out

    def shift(self, shards: list) -> list:
        """The ring shift (JAX's ``ppermute`` by +1): position i + 1 (mod n)
        receives position i's shard, on its own device."""
        Line.calls["shift"] += 1
        out: list = [None] * self.n
        mine = set(self.local())
        ops, recvs = [], []
        for i in range(self.n):
            dst, src = (i + 1) % self.n, i
            if dst in mine and src in mine:
                out[dst] = shards[src].to(self.devices[dst])
            elif dst in mine or src in mine:
                # The receiver's own shard gives the shape and dtype (equal splits).
                if dst in mine:
                    buf = torch.empty_like(shards[dst], device=_comm_device())
                    ops.append(dist.P2POp(dist.irecv, buf, self.ranks[src], tag=i))
                    recvs.append((dst, buf))
                else:
                    buf = shards[src].to(_comm_device()).contiguous()
                    ops.append(dist.P2POp(dist.isend, buf, self.ranks[dst], tag=i))
        if ops:
            # One batch: NCCL groups the sends and receives, so no order of
            # posting can deadlock.
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for dst, buf in recvs:
            out[dst] = buf.to(self.devices[dst])
        return out

    def share(self, shards: list) -> list[torch.Tensor]:
        """Every position's shard on this process's home device, in position
        order (the exchange behind ``psum`` and ``all_gather``).  Shards of
        one call share a shape and dtype."""
        home = self.mesh.home
        if not self.spans_processes:
            return [s.to(home) for s in shards]
        _, world = _process()
        mine = self.local()
        # Shape and dtype from a local shard, or from position 0's owner for
        # a process that holds no position of this line.
        meta = [None]
        if mine:
            meta = [(tuple(shards[mine[0]].shape), shards[mine[0]].dtype)]
        if any(r not in self.ranks for r in range(world)):
            dist.broadcast_object_list(meta, src=self.ranks[0])
        shape, dtype = meta[0]
        nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        dev = _comm_device()
        # Raw bytes: every dtype goes through, and no value is rounded.
        mine_buf = torch.zeros((self.n, nbytes), dtype=torch.uint8, device=dev)
        for i in mine:
            mine_buf[i] = shards[i].contiguous().reshape(-1).view(torch.uint8).to(dev)
        bufs = [torch.empty_like(mine_buf) for _ in range(world)]
        dist.all_gather(bufs, mine_buf)
        return [bufs[self.ranks[i]][i].view(dtype).reshape(shape).to(home)
                for i in range(self.n)]

    def psum(self, shards: list) -> torch.Tensor:
        """JAX's ``psum``: the shards added in position order on the home
        device (one rounding order for any device layout)."""
        Line.calls["psum"] += 1
        parts = self.share(shards)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def all_gather(self, shards: list) -> torch.Tensor:
        """JAX's ``all_gather``: the shards stacked in position order on the
        home device."""
        Line.calls["all_gather"] += 1
        return torch.stack(self.share(shards))

    def concat(self, shards: list) -> torch.Tensor:
        """The shards joined along axis 0 on the home device (the gathered
        output of a sharded axis)."""
        return torch.cat(self.share(shards))


def reset_collective_counts() -> None:
    """Zero ``Line.calls``."""
    for k in Line.calls:
        Line.calls[k] = 0


def _comm_device() -> torch.device:
    """Where torch.distributed's backend takes its tensors: the CPU for
    gloo, the current CUDA device for nccl."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def map_shards(line: Line, fn, *arrays, out: int) -> tuple[torch.Tensor, ...]:
    """Split each [P, ...] array (None passes through) over ``line``, run
    ``fn(device, *shard_arrays)`` once for each local position, and join
    each of its ``out`` outputs along axis 0 on the home device."""
    shards = [line.split(a) for a in arrays]
    outs: list = [[None] * line.n for _ in range(out)]
    for i in line.local():
        res = fn(line.devices[i], *(s[i] for s in shards))
        for k in range(out):
            outs[k][i] = res[k]
    return tuple(line.concat(o) for o in outs)

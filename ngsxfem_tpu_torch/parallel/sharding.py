"""Element sharding over ``torch.distributed``.

Counterpart of ``ngsxfem_tpu/parallel/sharding.py``.  The JAX package places
the element-indexed arrays on a device mesh and lets XLA's SPMD partitioner
split the pipelines and insert the reductions.  PyTorch has no such
partitioner, so here the pipelines are explicit: ``shard_mesh`` records on
the mesh which contiguous chunk of elements this rank owns, the cut
quadrature tiers of ``Integrate``, ``BilinearForm.Assemble`` and
``LinearForm.Assemble`` keep only the owned rows (``integrate.tier_rows``),
and the results are summed over the ranks with one ``all_reduce``.

One rank runs per process.  The backend follows the device: NCCL for CUDA
tensors, one rank per card (rank r on ``cuda:r``, or on ``cuda:LOCAL_RANK``
under a launcher that sets it: ``rank_device``), gloo on the CPU; asking for
NCCL without a card, or for more ranks than cards, raises, and nothing falls
back to gloo or to a shared card.  ``spawn_ranks`` starts one NCCL rank per
card by default, as the reference's layouts run on the accelerator's chips,
and n gloo ranks with ``device="cpu"``, the counterpart of the reference's
virtual CPU devices (``virtual_cpu_devices``); it meets its ranks through a
``FileStore`` in a temporary directory, never a fixed TCP port.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

# seconds a collective waits for its peers before it raises
TIMEOUT_S = 300
# seconds spawn_ranks waits for a rank's result; torch threads of a rank
RESULT_TIMEOUT_S = 600
RANK_THREADS = 1


class ShardGroup:
    """One rank's handle on a process group: ``rank``, ``world_size``, the
    ``device`` its tensors live on and the ``torch.distributed`` group
    (None for the default group).  Counts the collectives it issues and the
    bytes they carry (``calls``, ``bytes``), whatever the world size."""

    def __init__(self, rank, world_size, device, pg=None):
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.device = torch.device(device)
        self.pg = pg
        self.calls = 0
        self.bytes = 0

    def _count(self, t):
        self.calls += 1
        self.bytes += t.numel() * t.element_size()

    def all_reduce(self, t):
        """Sum ``t`` over the ranks, in place; returns ``t``.  An empty
        ``t`` (the shared buffer of one rank) is counted and sent nowhere."""
        self._count(t)
        if t.numel():
            dist.all_reduce(t, group=self.pg)
        return t

    def broadcast(self, t, src=0):
        """``t`` of rank ``src`` (a rank of this group) on every rank, in
        place; returns ``t``."""
        self._count(t)
        dist.broadcast(t, dist.get_global_rank(self.pg, src)
                       if self.pg is not None else src, group=self.pg)
        return t

    def all_gather(self, t):
        """Every rank's ``t`` (one shape on all ranks), in rank order."""
        self._count(t)
        out = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(out, t.contiguous(), group=self.pg)
        return out

    def exchange(self, sends, recvs):
        """Point-to-point exchange with other ranks of the group: ``sends``
        and ``recvs`` are lists of (tensor, group rank); every send and
        receive is posted at once (``batch_isend_irecv``) and waited for.
        A send and the receive it meets must have one dtype and size: gloo
        does not check."""
        ops = []
        for t, peer in sends:
            self._count(t)
            ops.append(dist.P2POp(dist.isend, t, self._global(peer),
                                  group=self.pg))
        for t, peer in recvs:
            ops.append(dist.P2POp(dist.irecv, t, self._global(peer),
                                  group=self.pg))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def _global(self, rank):
        return (dist.get_global_rank(self.pg, rank) if self.pg is not None
                else rank)

    def subgroup(self, width):
        """The group of the first ``width`` ranks (every rank must call
        this, as ``dist.new_group`` asks); None on the ranks outside it."""
        pg = dist.new_group(ranks=list(range(width)))
        if self.rank >= width:
            return None
        return ShardGroup(self.rank, width, self.device, pg)

    def __repr__(self):
        return (f"ShardGroup(rank={self.rank}, world_size={self.world_size}, "
                f"device={self.device})")


def backend_for(device):
    """The backend of a device: NCCL for a CUDA device, gloo for the CPU.
    NCCL without a card raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA card and none is available")
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def rank_device(rank, n_cards=None):
    """The card of rank ``rank`` on its host: ``cuda:LOCAL_RANK`` when a
    launcher set ``LOCAL_RANK`` (one process per card), else ``cuda:rank``.
    ``n_cards`` is the number of visible cards (``torch.cuda.device_count()``
    when None).  Raises when the card is not below it: two ranks never share
    a card (NCCL refuses it) and nothing falls back to the CPU."""
    local = os.environ.get("LOCAL_RANK", "")
    idx = int(local) if local else int(rank)
    if n_cards is None:
        n_cards = torch.cuda.device_count()
    if not 0 <= idx < n_cards:
        raise RuntimeError(
            f"rank {rank} needs CUDA card {idx} and {n_cards} are visible: "
            "one NCCL rank runs per card; pass device='cpu' for gloo ranks")
    return torch.device("cuda", idx)


def init_group(rank, world_size, store_path, device=None):
    """``init_process_group`` for this rank through a ``FileStore`` at
    ``store_path`` (a file every rank can reach; it must not exist before
    the first rank starts), with the backend of its device: by default the
    rank's own card (``rank_device``), made the current card before NCCL
    starts, or the given ``device`` (``"cpu"`` for gloo).  Returns the
    ``ShardGroup``; ``dist.destroy_process_group()`` ends it."""
    device = rank_device(rank) if device is None else torch.device(device)
    backend = backend_for(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return ShardGroup(rank, world_size, device)


def device_mesh(device=None):
    """The ``ShardGroup`` of the default process group, already
    initialised by the caller (the counterpart of the reference's
    ``device_mesh``); ``device`` defaults to this rank's card, or the CPU
    under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs an initialised process group "
                           "(init_group or spawn_ranks)")
    if device is None:
        if dist.get_backend() == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device("cpu")
    return ShardGroup(dist.get_rank(), dist.get_world_size(), device)


def element_chunks(ne, n, planes=None):
    """(ne,) int32 chunk of every element for ``n`` ranks: contiguous
    chunks; with ``planes`` (the cell planes of a structured mesh along its
    slowest axis, ``ne`` a multiple of them) aligned to the planes, so that
    neighbouring chunks share one vertex plane, the partition of
    ``UnfittedPoisson.spmd_step_sharded``."""
    e = np.arange(ne, dtype=np.int64)
    if planes is None:
        return ((e * n) // max(ne, 1)).astype(np.int32)
    per = ne // planes
    if per * planes != ne:
        raise ValueError(f"{ne} elements are not {planes} planes")
    plane = np.minimum(e // per, planes - 1)
    return ((plane * n) // planes).astype(np.int32)


class MeshShard:
    """The chunk of a sharded mesh that this rank owns: ``chunk`` (ne,)
    host int32, ``own`` its (ne,) host mask, and the group."""

    def __init__(self, group, chunk):
        self.group = group
        self.chunk = chunk
        self.own = chunk == group.rank
        self._dev = {}

    def own_on(self, device):
        """``own`` as a bool tensor on ``device``, made once per device."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.own, device=device)
        return self._dev[key]


def shard_mesh(mesh, group, planes=None):
    """Element-shard a mesh: this rank owns the chunk ``element_chunks``
    gives it (plane-aligned with ``planes``).  The cut tiers of
    ``Integrate`` and of the forms' ``Assemble`` then keep the owned rows
    only, and their results are summed over ``group``.  Returns the mesh."""
    mesh.shard = MeshShard(group, element_chunks(mesh.ne, group.world_size,
                                                 planes))
    return mesh


def shard_space(space, group, planes=None):
    """Element-shard a space: its mesh is sharded over ``group`` (once; a
    mesh already sharded over the same group keeps its chunks).  Dof
    vectors stay whole on every rank.  Returns the space."""
    mesh = space.mesh
    sh = getattr(mesh, "shard", None)
    if sh is None or sh.group is not group:
        shard_mesh(mesh, group, planes)
    return space


def mesh_shard(mesh):
    """The ``MeshShard`` of a mesh, or None on one rank."""
    return getattr(mesh, "shard", None)


def sum_over_ranks(mesh, t):
    """``t`` summed over the ranks of a sharded mesh (in place), unchanged
    on one rank."""
    sh = mesh_shard(mesh)
    if sh is not None:
        sh.group.all_reduce(t)
    return t


def replicate(t, group):
    """Rank 0's ``t`` on every rank of ``group``, on the group's device (a
    broadcast, the counterpart of the reference's replicated placement)."""
    t = torch.as_tensor(t).to(group.device).contiguous()
    return group.broadcast(t, 0)


def _spawn_device(n, device):
    """The device ``spawn_ranks`` gives ``init_group`` in its n ranks: None
    (each rank's own card) by default, after checking that n cards are
    visible; the CPU for ``"cpu"``."""
    if device is None:
        cards = torch.cuda.device_count()
        if cards < n:
            raise RuntimeError(
                f"spawn_ranks({n}): one NCCL rank per card needs {n} CUDA "
                f"cards and {cards} are visible; pass device='cpu' for gloo "
                "ranks")
        return None
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    raise ValueError(f"spawn_ranks runs one rank per card (device=None) or "
                     f"gloo ranks (device='cpu'), not on {device}")


def _rank_main(rank, world_size, store_path, device, fn, args, results):
    try:
        torch.set_num_threads(RANK_THREADS)
        if device is None:  # spawned rank r is local rank r of this host
            os.environ["LOCAL_RANK"] = str(rank)
        group = init_group(rank, world_size, store_path, device=device)
        try:
            out = fn(group, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(n, fn, *args, device=None):
    """Run ``fn(group, *args)`` on ``n`` ranks, one spawned process each
    with ``RANK_THREADS`` torch threads, and return their results in rank
    order (they are pickled, so ``fn`` is a module-level function).  By
    default the ranks are NCCL ranks, rank r on card r, and this raises
    before spawning when fewer than n cards are visible; ``device="cpu"``
    gives gloo ranks on the CPU.  The ranks meet through a ``FileStore`` in
    a fresh temporary directory.  A rank that raises makes this raise with
    its traceback, as does a rank with no result after
    ``RESULT_TIMEOUT_S``; every process is ended before this returns."""
    device = _spawn_device(n, device)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ngsxfem_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, store, device, fn, args,
                                   results),
                             daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        got = {}
        try:
            while len(got) < n:
                try:
                    rank, ok, out = results.get(timeout=RESULT_TIMEOUT_S)
                except queue.Empty:
                    raise TimeoutError(f"spawn_ranks: no result from ranks "
                                       f"{sorted(set(range(n)) - set(got))} "
                                       f"within {RESULT_TIMEOUT_S} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = out
        finally:
            for p in procs:
                p.join(timeout=30)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    return [got[r] for r in range(n)]

"""Process groups and the mesh's collectives on ``torch.distributed``
(counterpart of ``gscream_tpu/parallel/distributed.py``).

One process drives one card.  :func:`init_distributed` starts this
process's rank: from the JAX package's flags (``--dist_coordinator
HOST:PORT --dist_nprocs N --dist_pid I``, which here mean the world size
and the rank) or from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).  The
backend is NCCL for CUDA devices and gloo for the CPU unless the caller
names one; NCCL with more ranks on a host than it has cards raises, and
gloo lets ranks share a card.

The collectives the mesh needs are gathers summed in group-rank order,
so every rank of a group holds the bit-same result whatever the backend
(``all_reduce`` leaves its order to the backend).  Under gloo a CUDA
tensor is copied through host memory, explicitly and only there
(:func:`all_gather` counts it); under NCCL it never is.

The differentiable ones are ``torch.autograd.Function``s whose backward
is the collective's adjoint in torch's ``all_reduce`` convention: a
rank's cotangent of a collective's output is its own share of the
cotangent, so the backward sums the shares over the group.  A value that
every rank holds alike (a band-reduced loss) is therefore differentiated
once: one rank seeds it and the others seed zero (``parallel/shard.py``).

:func:`spawn` starts a world of local processes for the tests and
``chip_smoke.py``: ``file://`` rendezvous, a process-group timeout so a
hung collective fails instead of stalling, one thread per CPU rank.  Its
worker functions live in this package (``parallel/workers.py``), so a
child imports neither a test module nor JAX.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600   # of a process group's collectives


def init_distributed(coordinator: str = "", num_processes: int = 1,
                     process_id: int = 0, *, backend: Optional[str] = None,
                     device="cuda",
                     timeout_s: int = DEFAULT_TIMEOUT_S
                     ) -> Optional[torch.device]:
    """Start this process's rank; returns its device, or None (and does
    nothing) for a single process.  ``coordinator`` is ``host:port`` of
    rank 0, ``num_processes`` the world size and ``process_id`` the rank;
    without a coordinator, ``torchrun``'s environment is read.  A CUDA
    rank's card is ``cuda:LOCAL_RANK``."""
    env = os.environ
    if coordinator:
        if num_processes <= 1:
            return None
        rank, world = process_id, num_processes
        init_method = f"tcp://{coordinator}"
    elif "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        if world <= 1:
            return None
        init_method = "env://"
    else:
        return None
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dev = rank_device(dev, local_rank, local_world, backend)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return dev


def rank_device(device, local_rank: int, local_world: int,
                backend: str) -> torch.device:
    """The device of the rank ``local_rank`` of ``local_world`` on this
    host: the CPU, or ``cuda:local_rank`` (NCCL, one card per rank) or
    ``cuda:local_rank % cards`` (gloo, which may share a card)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        if backend == "nccl":
            raise ValueError("the NCCL backend needs CUDA devices")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank was asked for but "
                           "torch.cuda.is_available() is False")
    cards = torch.cuda.device_count()
    if backend == "nccl" and local_world > cards:
        raise RuntimeError(
            f"NCCL needs one card per rank: {local_world} ranks on this "
            f"host, {cards} card(s); use the gloo backend to share a card")
    dev = torch.device("cuda", local_rank % cards)
    torch.cuda.set_device(dev)
    return dev


def process_info():
    """(rank, world size, backend) of this process; (0, 1, None) without
    a process group."""
    if not dist.is_initialized():
        return 0, 1, None
    return dist.get_rank(), dist.get_world_size(), dist.get_backend()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """``t`` from every rank of ``group``, in group-rank order (a group of
    one gives ``[t]``).  Under gloo a CUDA tensor goes through host
    memory; ``all_gather.staged`` counts those calls and their bytes."""
    n = group_size(group)
    if n == 1:
        return [t]
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    src = t.reshape(-1).contiguous()
    src = src.cpu() if staged else src
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    if staged:
        all_gather.staged["calls"] += 1
        all_gather.staged["bytes"] += src.numel() * src.element_size() * (
            n + 1)
    return [o.to(t.device).reshape(t.shape) for o in out]


all_gather.staged = {"calls": 0, "bytes": 0}


def ordered_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return s


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` in group-rank order, outside autograd."""
    return ordered_sum(all_gather(t, group))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return sum_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return sum_over(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group`` (JAX ``lax.psum``); the adjoint sums the
    cotangents' shares over the group."""
    return x if group_size(group) == 1 else _PSum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return psum(x, group) / group_size(group)


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = torch.stack(all_gather(x, group)).amax(0)
        ctx.group = group
        ctx.save_for_backward(x == out)
        return out

    @staticmethod
    def backward(ctx, g):
        (hit,) = ctx.saved_tensors
        total = sum_over(g, ctx.group)
        ties = sum_over(hit.to(g.dtype), ctx.group)
        return torch.where(hit, total / ties, torch.zeros_like(g)), None


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over ``group`` (the overflow check's demand);
    the adjoint gives the summed cotangent to the ranks that hold the
    max, split evenly between ties."""
    return x if group_size(group) == 1 else _PMax.apply(x, group)


class _NeighbourExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, band, group, n_bands: int, index: int, rows: int):
        ctx.group, ctx.n, ctx.index, ctx.rows = group, n_bands, index, rows
        parts = all_gather(torch.stack([band[..., :rows, :],
                                        band[..., -rows:, :]]), group)
        zero = torch.zeros_like(band[..., :rows, :])
        top = parts[index - 1][1] if index > 0 else zero
        bot = parts[index + 1][0] if index < n_bands - 1 else zero
        return torch.cat([top, band, bot], dim=-2)

    @staticmethod
    def backward(ctx, g):
        # each received row's cotangent goes back to the band that sent
        # it: this band's top edge was band index-1's bottom halo, its
        # bottom edge band index+1's top halo
        r = ctx.rows
        parts = all_gather(torch.stack([g[..., :r, :], g[..., -r:, :]]),
                           ctx.group)
        own = g[..., r:-r, :].clone()
        if ctx.index > 0:
            own[..., :r, :] += parts[ctx.index - 1][1]
        if ctx.index < ctx.n - 1:
            own[..., -r:, :] += parts[ctx.index + 1][0]
        return own, None, None, None, None


def neighbour_exchange(band: torch.Tensor, group, n_bands: int, index: int,
                       rows: int) -> torch.Tensor:
    """(…, bh, W) of band ``index`` of ``n_bands`` (the ranks of ``group``
    in band order) → (…, rows + bh + rows, W): the band between the last
    ``rows`` rows of the band above and the first ``rows`` of the band
    below, zeros past the first and the last band (JAX: two
    ``ppermute``s).  The adjoint sends the cotangents of the received
    rows back to their senders."""
    return _NeighbourExchange.apply(band, group, n_bands, index, rows)


# --- local worlds for the tests and chip_smoke.py -------------------------

def _worker(fn, rank: int, world: int, tmp: str, backend: str, device,
            timeout_s: int, threads: int, without):
    err = os.path.join(tmp, f"rank{rank}.err")
    for name in without:
        sys.modules[name] = None
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(threads)
            torch.set_num_interop_threads(threads)
        dev = rank_device(device, rank, world, backend)
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
            world_size=world, rank=rank,
            timeout=timedelta(seconds=timeout_s))
        args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
        result = fn(rank, world, dev, *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(err, "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn: Callable, world_size: int, *args, backend: str = "gloo",
          device="cpu", timeout_s: int = 300, threads: int = 1,
          without=()) -> list:
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size`` new
    processes joined into one process group; returns their results in
    rank order.  ``fn`` must be importable (a module-level function of
    this package); ``args`` and the results go through ``torch.save``.
    Raises if a rank fails, or terminates them all and raises when
    ``timeout_s`` passes (the process group times out a hung collective
    at the same limit).  The modules named in ``without`` are made
    unimportable in the ranks (the tests leave out TensorBoard, whose
    import takes seconds)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gscream_spawn_")
    try:
        torch.save(args, os.path.join(tmp, "args.pt"))
        procs = [ctx.Process(target=_worker, args=(
            fn, r, world_size, tmp, backend, device, timeout_s, threads,
            tuple(without))) for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s + 30
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
        if hung:
            raise TimeoutError(f"ranks {hung} of {world_size} still ran "
                               f"after {timeout_s} s")
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            msgs = []
            for r in failed:
                path = os.path.join(tmp, f"rank{r}.err")
                text = open(path).read() if os.path.exists(path) else ""
                msgs.append(f"rank {r} (exit {procs[r].exitcode}):\n{text}")
            raise RuntimeError("\n".join(msgs))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

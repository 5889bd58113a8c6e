"""Process bootstrap, host barriers, multi-process checkpoints and the
collectives of the sharded paths (port of
langsplatv2_tpu/parallel/distributed.py on torch.distributed).

- `initialize_distributed()`: explicit arguments first, then torch's own
  environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as torchrun
  sets them); otherwise a single-process no-op that returns False. Safe to
  call twice. The backend is what the caller asks for, by default NCCL on
  a CUDA host and gloo elsewhere. Ranks that share one card must ask for
  gloo themselves (NCCL refuses two ranks on one device); nothing switches
  the backend on its own.
- `sync_hosts(name)`: a barrier, a no-op in one process.
- `save_checkpoint_multihost()`: rank 0 writes models/io.py's checkpoint
  between two barriers (the training state is replicated over the ranks).
- `spawn_ranks()`: starts a world of processes on one host, each
  initialized through a `file://` store, and returns what each rank's
  function returned.

The collectives below (`all_reduce_`, `all_to_all`, `all_gather`) act on
a process group (in a world of one rank too, through its backend) and are
the identity without an initialized process group (a mesh of one). Where
the group's backend is gloo and the tensor lies on the card, they copy
through the host themselves: gloo moves host memory.
"""
from __future__ import annotations

import os
import queue
import traceback
from pathlib import Path

import torch
import torch.distributed as dist


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None) -> bool:
    """Join the process group. Returns True when running multi-process.

    Resolution order: explicit arguments > torchrun's environment
    (MASTER_ADDR and MASTER_PORT give init_method "env://", WORLD_SIZE and
    RANK the rest) > single-process no-op. `backend` defaults to "nccl"
    where CUDA is available, else "gloo". With NCCL the rank's current
    device is set to cuda:(LOCAL_RANK or rank) % device_count first."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None and os.environ.get("MASTER_ADDR") and \
            os.environ.get("MASTER_PORT"):
        init_method = "env://"
    if init_method is None and world_size is None:
        return False
    if world_size is None or rank is None:
        raise ValueError("initialize_distributed needs world_size and rank "
                         "(arguments or WORLD_SIZE / RANK)")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device((rank if local is None else local)
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dist.get_world_size() > 1


def sync_hosts(name: str = "barrier") -> None:
    """Block until every process reaches this point (no-op in one
    process). `name` labels the call site only."""
    del name
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        dist.barrier()


def save_checkpoint_multihost(path: str, model, optimizer, iteration: int,
                              extra: dict | None = None) -> None:
    """Rank 0 writes models/io.py's checkpoint (the schema one process
    reads back) between two barriers. The model and optimizer state are
    the replicated training state; a Gaussian-sharded model is gathered
    by the caller first."""
    from ..models import io as mio

    sync_hosts("pre-checkpoint")
    if not dist.is_initialized() or dist.get_rank() == 0:
        mio.save_checkpoint(path, model, optimizer, iteration, extra=extra)
    sync_hosts("post-checkpoint")


# ------------------------------------------------------------ collectives

def _active(group) -> bool:
    """A process group exists (a world of one rank still runs the
    backend's collective)."""
    return dist.is_available() and dist.is_initialized()


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """In-place all-reduce of `t` over `group`; returns `t`."""
    if not _active(group):
        return t
    if _staged(t, group):
        host = t.detach().cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """Equal splits of dim 0: block j of `t` goes to the group's rank j,
    block i of the result came from its rank i."""
    if not _active(group):
        return t.clone()
    src = t.detach().contiguous()
    if _staged(src, group):
        host = src.cpu()
        out = torch.empty_like(host)
        dist.all_to_all_single(out, host, group=group)
        return out.to(t.device)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The group's tensors concatenated along dim 0 in rank order."""
    if not _active(group):
        return t.detach().clone()
    src = t.detach().contiguous()
    n = dist.get_world_size(group)
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


class GatherStrips(torch.autograd.Function):
    """all_gather along dim 0 whose backward is its transpose: the
    cotangents of every rank's copy summed, and this rank's block kept
    (JAX's all_gather / psum_scatter pair)."""

    @staticmethod
    def forward(ctx, t, group, index):
        ctx.group, ctx.index, ctx.n = group, index, t.shape[0]
        return all_gather(t, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g[ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None, None


def gather_strips(t: torch.Tensor, group, index: int) -> torch.Tensor:
    """Differentiable all_gather of this rank's block `t` (rank `index`
    of `group`)."""
    if not _active(group):
        return t
    return GatherStrips.apply(t, group, index)


# ------------------------------------------------------------- launching

def _rank_entry(fn, rank: int, world: int, init_method: str, backend: str,
                args: tuple, results) -> None:
    try:
        initialize_distributed(init_method, world, rank, backend)
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:    # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, args: tuple = (), *, store_dir,
                backend: str = "gloo", timeout: float = 600.0) -> list:
    """Run fn(rank, world, *args) in `world` new processes (the spawn
    start method: `fn` must be importable by name, from a module the
    child can import), each joined to a process group through the
    `file://` store `store_dir/store` (which must not exist yet). Returns
    the ranks' return values in rank order. Raises, after stopping every
    process, if a rank raised, died or outlived `timeout` seconds."""
    import multiprocessing as mp
    import time

    store = Path(store_dir) / "store"
    if store.exists():
        raise FileExistsError(f"{store}: a file store must be new")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"file://{store.resolve()}"
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, init, backend, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn_ranks: {world - len(out)} of "
                                   f"{world} ranks unfinished after "
                                   f"{timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn_ranks: a rank exited with "
                                       f"{dead[0]} before reporting")
                continue
            if not ok:    # the others may wait in a collective: stop all
                raise RuntimeError(f"spawn_ranks: rank {rank} failed:\n"
                                   f"{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [out[r] for r in range(world)]

"""Several processes, one device each: ``torch.distributed`` in place of the
JAX package's ``jax.distributed`` (port of
``rgie_tpu/parallel/distributed.py``).

Launch contract, read by ``init_distributed`` (explicit arguments win):

    torchrun's   RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT
    or the JAX package's
                 RGIE_COORDINATOR     host:port of process 0
                 RGIE_NUM_PROCESSES   world size
                 RGIE_PROCESS_ID      this process's rank
                 (LOCAL_RANK, if set, else the rank, picks the card)

A single-process run (none of these set, or a world of 1) is a no-op, so
every CLI calls it unconditionally (through ``process_device``).

Rank to device: the backend is ``nccl`` for CUDA and ``gloo`` for the CPU
unless the caller names one. Under NCCL rank r runs on ``cuda:LOCAL_RANK``,
and more local ranks than cards is an error: NCCL refuses two ranks on one
card, and nothing here swaps in the CPU. With an explicit ``gloo`` group,
ranks may share a card (``cuda:LOCAL_RANK % cards``): gloo takes CUDA tensors
for its all-reduce and broadcast and stages them through host memory.

``parallel/mesh.py`` lays the processes out over (data, model); the model
axis stays on one host (``LOCAL_WORLD_SIZE``, torchrun's count of this host's
processes, or every process when it is not set).

One process per device means each rank simply keeps its own rows: JAX's
``global_from_local`` and ``local_rows``, which assemble one global array
over a mesh and take a process's rows back out of it, have no counterpart.
A rank's rows are its local tensors, fed by ``data.dataset.ShardedView``.
"""

from __future__ import annotations

import os
import socket
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

#: How long a process waits for its peers to join the group or a collective
#: before it raises: a half-configured launch fails instead of hanging.
DEFAULT_TIMEOUT = timedelta(minutes=5)


class LaunchEnv(NamedTuple):
    rank: int
    world_size: int
    local_rank: int
    address: Optional[str]   # host:port of rank 0's store


def launch_env() -> LaunchEnv:
    """The launch this process belongs to, from torchrun's variables or else
    the JAX package's ``RGIE_*`` ones; a single process without either."""
    env = os.environ
    if "WORLD_SIZE" in env:
        rank = int(env.get("RANK", "0"))
        addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
        return LaunchEnv(rank, int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", rank)),
                         f"{addr}:{port}" if addr and port else None)
    if "RGIE_NUM_PROCESSES" in env or "RGIE_COORDINATOR" in env:
        rank = int(env.get("RGIE_PROCESS_ID", "0"))
        return LaunchEnv(rank, int(env.get("RGIE_NUM_PROCESSES", "1")),
                         int(env.get("LOCAL_RANK", rank)), env.get("RGIE_COORDINATOR"))
    return LaunchEnv(0, 1, 0, None)


def _nccl_device(local_rank: int) -> torch.device:
    count = torch.cuda.device_count()
    if local_rank >= count:
        raise RuntimeError(f"local rank {local_rank} has no card of its own: this host has {count} "
                           "CUDA device(s) and NCCL runs one rank per card; start at most that many "
                           "processes per host, or name backend='gloo' to share a card")
    return torch.device("cuda", local_rank)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device_type: str = "cuda",
                     timeout: timedelta = DEFAULT_TIMEOUT) -> bool:
    """Start this process's group. Returns True when a group is (now) active,
    False for a single-process run; an explicit ``num_processes=1`` starts a
    group of one. A second call is a no-op. ``backend`` defaults to ``nccl``
    for ``device_type`` cuda and ``gloo`` otherwise."""
    if dist.is_initialized():
        return True
    env = launch_env()
    world = env.world_size if num_processes is None else num_processes
    rank = env.rank if process_id is None else process_id
    address = coordinator_address or env.address
    if world <= 1 and num_processes is None:
        return False
    if address is None:
        raise RuntimeError(f"a launch of {world} processes names no coordinator: set MASTER_ADDR "
                           "and MASTER_PORT (torchrun does) or RGIE_COORDINATOR=host:port")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    device_id = None
    if backend == "nccl":
        device_id = _nccl_device(env.local_rank)
        torch.cuda.set_device(device_id)
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world,
                            rank=rank, timeout=timeout, device_id=device_id)
    return True


def process_info() -> Tuple[int, int]:
    """(rank, world size): the group's once it is started, else the launch's
    (what ``init_distributed`` would start), so a CLI can check its batch
    before any process waits on another."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = launch_env()
    return env.rank, env.world_size


def is_main_process() -> bool:
    """Rank 0, which alone writes checkpoints."""
    return process_info()[0] == 0


def all_processes_barrier() -> None:
    """Block until every process reaches this point (``dist.barrier``); a
    single process passes straight through."""
    if dist.is_initialized():
        dist.barrier()


def process_device(name: str) -> torch.device:
    """This process's device for ``--device name``: ``resolve_device``'s
    check first, then ``init_distributed`` with the backend of the device's
    type, then, under a group and ``cuda`` without an index, the rank's card
    (see the module's docstring). A single process gets ``resolve_device``'s
    device."""
    from rgie_tpu_torch.device import resolve_device

    device = resolve_device(name)
    init_distributed(device_type=device.type)
    if device.type != "cuda" or device.index is not None or not dist.is_initialized():
        return device
    local = launch_env().local_rank
    if dist.get_backend() == "nccl":
        return _nccl_device(local)
    return torch.device("cuda", local % torch.cuda.device_count())


def split_batch(global_batch: int, flag: str = "--batch") -> int:
    """Each process's share of a global batch; exits, as the JAX CLIs do,
    when it does not divide over the processes."""
    nproc = process_info()[1]
    if global_batch % nproc:
        raise SystemExit(f"{flag} {global_batch} must divide over {nproc} processes")
    return global_batch // nproc


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, port, backend, results, inputs):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world_size), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        args = inputs.get()
        init_distributed(f"127.0.0.1:{port}", world_size, rank, backend=backend)
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, *args: Any, backend: str = "gloo",
                timeout: float = 900.0) -> List[Any]:
    """Run ``fn(*args)`` in ``world_size`` new processes (``spawn``) that form
    one ``backend`` group on this host, and return each rank's result in rank
    order. ``fn`` must be importable by name and its result picklable. The
    first rank that raises or dies, or ``timeout`` seconds, ends every rank
    and raises here."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    results, inputs = ctx.Queue(), ctx.Queue()
    # The arguments go through a queue, not the process objects: a child
    # reads its process object only after importing the main module, and the
    # parent's start blocks until a large one is read, which would start the
    # ranks one after another. (A rank that dies before reading them must not
    # keep this process waiting to flush them at its exit.)
    inputs.cancel_join_thread()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, rank, world_size, port, backend, results,
                                                   inputs), daemon=True)
             for rank in range(world_size)]
    for p in procs:
        p.start()
    for _ in procs:
        inputs.put(args)
    done, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(done) < world_size and failure is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs) if i not in done and p.exitcode not in (None, 0)]
                if dead:
                    failure = f"rank {dead[0]} died with exit code {procs[dead[0]].exitcode}"
                elif time.monotonic() > deadline:
                    failure = f"ranks {sorted(set(range(world_size)) - set(done))} still running " \
                              f"after {timeout:.0f} s"
                continue
            if ok:
                done[rank] = value
            else:
                failure = f"rank {rank} raised:\n{value}"
    finally:
        for p in procs:
            if failure is None:
                p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if failure is not None:
        raise RuntimeError(f"spawn_ranks({getattr(fn, '__name__', fn)}): {failure}")
    return [done[rank] for rank in range(world_size)]

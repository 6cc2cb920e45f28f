"""Multi-process runtime: joining the process group, and spawning ranks.

Port of ``supersonic_tpu/parallel/multihost.py``.  Each process (one per
card) calls ``initialize`` first: ``torch.distributed.init_process_group``
over NCCL for the card, or over gloo when the caller asks for the CPU,
with a ``tcp://`` rendezvous at the coordinator's address.  After it,
``global_mesh()`` spans every rank and every ``parallel/`` primitive works
unchanged.  ``spawn`` starts ``n`` such ranks on this host and runs one
function on each (``parallel.dryrun`` uses it when no group exists).
"""
from __future__ import annotations

import datetime
import os
import socket
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

# seconds a collective, a rendezvous or a spawned rank may take
TIMEOUT_S = 300


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda") -> None:
    """Join the process group as rank ``process_id`` of ``num_processes``,
    meeting at ``coordinator_address`` ("host:port", where rank 0 listens).
    With no address, the ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``
    and ``RANK`` environment variables (as ``torchrun`` sets them) give
    them.  On ``device="cuda"`` the rank takes card ``process_id`` modulo
    the cards present and joins over NCCL, which connects at once (a
    failure raises here); on the CPU it joins over gloo."""
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    kw = {}
    if torch.device(device).type == "cuda":
        card = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(card)
        backend, kw["device_id"] = "nccl", card
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)


def is_multihost() -> bool:
    """True in a process group of more than one process."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def global_mesh(n_devices: Optional[int] = None, device=None):
    """Mesh over every rank of the group (call after ``initialize``)."""
    from .dist import make_mesh

    return make_mesh(n_devices, device=device)


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(address, n, rank, device, threads, fn, args, queue):
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize(address, n, rank, device)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, out))
    except Exception:
        queue.put((rank, False, traceback.format_exc()))


def spawn(n: int, fn: Callable, args: tuple = (), device="cuda",
          threads: Optional[int] = None) -> list:
    """Run ``fn(*args)`` on ``n`` new processes, ranks 0..n-1 of a process
    group of their own (NCCL on cards 0..n-1, or gloo on the CPU), and
    return their results in rank order.  ``fn`` must be importable by
    name (a module-level function).  A rank that fails raises here with
    its traceback, and the other ranks are stopped; so are ranks that have
    not answered within ``TIMEOUT_S``.  ``threads`` sets each rank's
    intra-op threads."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = f"localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(address, n, r, device, threads, fn, args,
                               results))
             for r in range(n)]
    for p in procs:
        p.start()
    out: dict = {}
    try:
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=TIMEOUT_S)
        while len(out) < n:
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                rank, ok, value = results.get(timeout=max(left, 0.01))
            except queue_mod.Empty:
                raise TimeoutError(
                    f"spawn: ranks {sorted(set(range(n)) - set(out))} did "
                    f"not finish within {TIMEOUT_S} s") from None
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10 if len(out) == n else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(n)]

"""Multi-process (multi-host) wiring for the corpus engine.

Port of :mod:`bjxa_tpu.parallel.distributed` on :mod:`torch.distributed`.
The reference is a single-process tool (SURVEY §2.5: "the reference has
none"); at corpus scale the unit of distribution is the file, mirroring the
reference's decoder-per-file model (``bjxa.3.rst.in:119-120``).  This module
owns the pieces the library needs to run one corpus job across N
cooperating processes:

* :func:`initialize` — joins a process group from CLI flags or
  ``BJXA_COORDINATOR``/``BJXA_NUM_PROCESSES``/``BJXA_PROCESS_ID``, with the
  JAX package's validation and messages.  The group is gloo over
  ``tcp://<coordinator>`` (process 0 listens there): only host integers
  ever cross it, so gloo serves on a plain host and on a GPU host alike.
* :func:`process_info` — the (index, count) every sharding decision keys
  on, read from the live process group.
* :func:`allreduce_sum` and :func:`allreduce_counters` — the cross-process
  reduction of the corpus counters (int64 sums, and the slowest process's
  elapsed time); the identity when single-process.
* :func:`shutdown` — leaves the group at the end of a job.

File I/O stays host-local: each process globs its own filesystem and takes
a round-robin shard of the sorted file list, so nothing crosses the network
but the final counter reduction.  Each process drives only its own devices
(:mod:`bjxa_tpu_torch.parallel.mesh`).  The JAX package also lets every rank
write its persistent compile cache (``_enable_rank_cache_writes``); the
port compiles nothing per process, so that has no counterpart.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from bjxa_tpu_torch.utils.profiler import Counters

#: Seconds a process waits for the others, to join the group and in each
#: collective, before it raises.
TIMEOUT_S = 300


def _env_int(name: str) -> int | None:
    val = os.environ.get(name)
    return int(val) if val not in (None, "") else None


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join the process group of a multi-process corpus job.

    Arguments fall back to ``BJXA_COORDINATOR`` / ``BJXA_NUM_PROCESSES`` /
    ``BJXA_PROCESS_ID``.  ``coordinator`` is ``host:port``; process 0
    listens there.  Returns True when the group was (newly or already)
    joined, False for a plain single-process run (no arguments given
    anywhere).  :data:`TIMEOUT_S` bounds the wait for the other processes,
    at the join and in every later collective.

    Raises :class:`ValueError` when the flags are inconsistent (e.g. a
    process id without a process count), with the JAX package's messages.
    """
    coordinator = coordinator or os.environ.get("BJXA_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("BJXA_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("BJXA_PROCESS_ID")

    if coordinator is None and num_processes is None and process_id is None:
        return False
    if num_processes is not None and num_processes < 1:
        raise ValueError("num_processes must be >= 1")
    if (process_id is None) != (num_processes is None):
        raise ValueError(
            "--process-id and --num-processes must be given together"
        )
    if process_id is not None and not (0 <= process_id < num_processes):
        raise ValueError("process id out of range")
    if dist.is_initialized():  # already wired
        return True
    # the checks of jax.distributed.initialize, which the JAX package's
    # call reaches next (no cluster to detect settings from)
    if coordinator is None:
        raise ValueError("coordinator_address should be defined.")
    if num_processes is None:
        raise ValueError("Number of processes must be defined.")
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    return True


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> tuple[int, int]:
    """(process_index, process_count) of the live group; (0, 1) when no
    group was joined."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def allreduce_sum(values) -> list[int]:
    """Element-wise sum of a small int vector across all processes (int64
    on the wire: corpus byte and sample counts exceed 2**31).

    Single-process: returns ``values`` as a list.  Multi-process: a
    collective every process must enter; each receives the global sums.
    """
    values = [int(v) for v in values]
    if process_info()[1] == 1:
        return values
    t = torch.tensor(values, dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return [int(v) for v in t]


def allreduce_counters(counters: Counters) -> Counters:
    """Sum throughput counters across all processes.

    Single-process: returns ``counters`` unchanged.  Multi-process: every
    process must call this (it is a collective); each receives the global
    totals.  Elapsed time is the max across processes (the job is done when
    the slowest host is).
    """
    if process_info()[1] == 1:
        return counters
    tot = allreduce_sum([counters.files, counters.blocks, counters.samples,
                         counters.bytes_in, counters.bytes_out])
    slowest = torch.tensor([int(counters.elapsed() * 1e9)], dtype=torch.int64)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    return Counters(
        files=tot[0],
        blocks=tot[1],
        samples=tot[2],
        bytes_in=tot[3],
        bytes_out=tot[4],
        frozen_s=int(slowest) / 1e9,
    )

"""Multi-process runtime layer.

The reference scales with a single-process ThreadPool over chromosomes
(src/commands.cpp:864-874, :955-978); here the scale-out axis is
multi-process JAX — processes joined through the distributed runtime
(Gloo on the CPU, NCCL between GPUs). Work placement:

  - read k-mer counting: every process streams a disjoint shard of the
    read file (round-robin by sequence index) against the SAME graph
    k-mer table (the graph build is deterministic), then the count
    vectors are summed across processes — the DCN analogue of the
    reference's jellyfish lock-free hash merge.
  - HMM grid: the (chromosome x path-subset) work items are partitioned
    round-robin across processes; each runs its items on its local
    devices, and the per-variant likelihoods are gathered to the
    coordinator (process 0) which combines them — the reference's
    result mutex (src/commands.cpp:163-185) becomes a gather — and
    writes the output VCFs.

Configuration: set PANGENIE_TPU_COORDINATOR=host:port,
PANGENIE_TPU_NUM_PROCESSES=N and PANGENIE_TPU_PROCESS_ID=i in each
process (or rely on jax.distributed auto-detection under SLURM by
setting PANGENIE_TPU_DISTRIBUTED=auto). Single-process runs never touch
jax.distributed and every helper degrades to the identity.

One card per process: a JAX process reserves most of every GPU it
sees, so several processes on one host must each be restricted to
their own card with CUDA_VISIBLE_DEVICES; a multi-process run on GPUs
that leaves a process more than one card refuses to start. One process
drives all of a host's cards without this layer (parallel/genotyping.py).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, List, Optional, Sequence

import numpy as np

_initialized = False


def maybe_initialize() -> bool:
    """Initialize jax.distributed from the environment (idempotent).

    Must run before the first JAX backend use. Returns True when the
    run is multi-process.
    """
    global _initialized
    if _initialized:
        return process_count() > 1
    coord = os.environ.get("PANGENIE_TPU_COORDINATOR")
    auto = os.environ.get("PANGENIE_TPU_DISTRIBUTED", "").lower() == "auto"
    if not coord and not auto:
        return False
    import jax

    _check_one_card_per_process()
    if coord:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["PANGENIE_TPU_NUM_PROCESSES"]),
            process_id=int(os.environ["PANGENIE_TPU_PROCESS_ID"]),
        )
    else:  # auto-detected cluster (SLURM, ...)
        jax.distributed.initialize()
    _initialized = True
    return process_count() > 1


def _check_one_card_per_process() -> None:
    """Refuse a multi-process run on GPUs unless CUDA_VISIBLE_DEVICES
    gives this process exactly one card."""
    from .. import backend

    if backend.cpu_only():
        return
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    if len([d for d in visible.split(",") if d.strip()]) != 1:
        raise RuntimeError(
            "multi-process runs on GPUs need one card per process: set "
            "CUDA_VISIBLE_DEVICES to a single device in each process "
            f"(found {visible!r}), or run one process for all cards."
        )


def process_count() -> int:
    import jax

    return jax.process_count()


def process_index() -> int:
    import jax

    return jax.process_index()


def is_coordinator() -> bool:
    return process_index() == 0


def partition(n_items: int) -> List[int]:
    """Round-robin item indices owned by this process. Deterministic and
    disjoint across processes; the union over all processes is
    range(n_items)."""
    return list(range(process_index(), n_items, process_count()))


def owns(index: int) -> bool:
    return index % process_count() == process_index()


# -- collectives over host data ---------------------------------------------

_CHUNK = 1 << 24  # elements per allgather chunk (bounds peak host memory)


def allreduce_sum(x: np.ndarray) -> np.ndarray:
    """Element-wise sum of ``x`` across all processes (host numpy in,
    host numpy out). Chunked so peak memory stays ~ n_proc * 64 MB."""
    if process_count() == 1:
        return x
    from jax.experimental import multihost_utils

    x = np.asarray(x)
    flat = x.reshape(-1)
    out = np.empty_like(flat)
    for start in range(0, max(len(flat), 1), _CHUNK):
        chunk = flat[start : start + _CHUNK]
        if not len(chunk):
            break
        gathered = multihost_utils.process_allgather(chunk)
        out[start : start + _CHUNK] = gathered.sum(axis=0).astype(flat.dtype)
    return out.reshape(x.shape)


def gather_objects(obj: Any) -> Optional[List[Any]]:
    """Gather one picklable object per process to the coordinator.

    Returns the list [obj_from_proc_0, ..., obj_from_proc_{n-1}] on the
    coordinator and None elsewhere. Implemented as a padded uint8
    allgather (lengths first) over the distributed runtime.
    """
    if process_count() == 1:
        return [obj]
    from jax.experimental import multihost_utils

    payload = np.frombuffer(
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), dtype=np.uint8
    )
    lengths = multihost_utils.process_allgather(
        np.asarray([len(payload)], dtype=np.int64)
    ).reshape(-1)
    max_len = int(lengths.max())
    padded = np.zeros(max_len, dtype=np.uint8)
    padded[: len(payload)] = payload
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    if not is_coordinator():
        return None
    return [
        pickle.loads(gathered[i, : int(lengths[i])].tobytes())
        for i in range(process_count())
    ]


def barrier(name: str = "pangenie") -> None:
    if process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def shard_sequences(seqs, shard: Optional[Sequence[int]]):
    """Yield every n-th sequence of an iterable: shard=(process index,
    process count). None = everything (single-process)."""
    if shard is None:
        yield from seqs
        return
    pid, n = shard
    for i, seq in enumerate(seqs):
        if i % n == pid:
            yield seq

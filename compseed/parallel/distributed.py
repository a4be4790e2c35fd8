"""Multi-host distribution: jax.distributed + deterministic shard merge.

The reference is single-node (POSIX shm shares the index between
processes on one machine, bwashm.c; kt_pipeline orders output,
cstl/kthread.c:95-105).  The multi-process equivalent implemented here:

  * ``init_distributed`` — pin each process of a multi-process launch to
    one local card, then bring up ``jax.distributed`` when a coordinator
    is given.
  * Work partitioning is BY -K CHUNK, round-robin on chunk index
    (``owns_chunk``): chunk k belongs to host k % n_hosts.  Chunk
    boundaries are byte-deterministic (fixed base count), so every host
    slices the identical chunk stream without coordination — the -K
    reproducibility contract (main.cpp:266,437) carried across hosts.
  * The FM-index is loaded per host (replicated — it is read-only; the
    intra-host story is parallel/sharded.py's mesh replication).
  * Each host writes ``out.shardNNNN`` files; ``merge_shards`` (or
    ``compseed merge``) concatenates records back into global chunk
    order.  Merge is pure file concatenation in chunk-index order, so
    the merged SAM is byte-identical to a single-host run.

Scaling expectation: alignment is embarrassingly parallel across chunks
(zero cross-host communication after init; the only shared resource is
the input filesystem), so host-count scaling is limited only by input
IO — the ≥80% N-host efficiency north star is structural rather than
tuned.  tests/test_distributed.py exercises the path with the processes
simulated process-locally.
"""

from __future__ import annotations

import glob
import os


def card_for_process(process_id: int, n_cards: int) -> int:
    """The local card a process of a multi-process launch owns: process
    ids are dealt round-robin over the host's cards."""
    return process_id % max(n_cards, 1)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Set up a multi-process launch (env: COMPSEED_COORD,
    COMPSEED_NPROCS, COMPSEED_PROC_ID).  Each process takes one local
    card (card_for_process), chosen before the device backend starts, so
    no two processes open the same card.  With a coordinator,
    ``jax.distributed`` is initialized over those cards.  Returns
    (process_id, n)."""
    import jax

    from compseed.device import local_card_count

    coordinator = coordinator or os.environ.get("COMPSEED_COORD")
    num_processes = num_processes if num_processes is not None else \
        int(os.environ.get("COMPSEED_NPROCS", "0") or 0)
    process_id = process_id if process_id is not None else \
        int(os.environ.get("COMPSEED_PROC_ID", "0") or 0)
    if num_processes <= 1:
        return 0, 1
    n_cards = local_card_count()
    card = card_for_process(process_id, n_cards) if n_cards else None
    if coordinator:
        jax.distributed.initialize(
            coordinator_address=coordinator, num_processes=num_processes,
            process_id=process_id,
            local_device_ids=None if card is None else [card])
    elif card is not None:
        # no coordinator: single-host multi-process partitioning (the
        # bwashm.c model — processes split the chunk stream; no
        # cross-process collectives are needed)
        jax.config.update("jax_cuda_visible_devices", str(card))
    return process_id, num_processes


def owns_chunk(chunk_index: int, process_id: int, n_processes: int) -> bool:
    """Deterministic chunk ownership: round-robin on the -K chunk index."""
    return chunk_index % max(n_processes, 1) == process_id


def shard_path(output: str, chunk_index: int) -> str:
    return f"{output}.shard{chunk_index:06d}"


def merge_shards(output: str, header: str | None = None,
                 remove: bool = True) -> int:
    """Concatenate per-chunk shard files into ``output`` in chunk-index
    order; returns the number of shards merged.  Byte-identical to the
    single-host stream because chunk boundaries are content-determined."""
    shards = sorted(glob.glob(f"{output}.shard*"))
    with open(output, "w") as out:
        if header is not None:
            out.write(header)
        for s in shards:
            with open(s) as f:
                out.write(f.read())
            if remove:
                os.remove(s)
    return len(shards)

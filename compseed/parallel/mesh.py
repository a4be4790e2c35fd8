"""Device-mesh data parallelism for the alignment pipeline.

The reference is single-node shared-memory (kt_for over 512-read tiles,
cstl/kthread.c; POSIX-shm index sharing, bwalib/bwashm.c).  The device
equivalent: the FM-index is replicated per device (it is read-only), read
batches shard over a `data` mesh axis, and per-shard results gather back
in deterministic -K order (SURVEY.md parallelism table).

``shard_align_step`` builds the pjit'd batched seeding+extension step used
by __graft_entry__.dryrun_multichip and pod-scale runs: reads are sharded
on `data`, the index replicated, outputs sharded like the inputs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from compseed.ops.device_index import DeviceFMIndex


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def replicate_index(mesh: Mesh, dfi: DeviceFMIndex) -> DeviceFMIndex:
    """Place every index array replicated on the mesh."""
    rep = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, rep), dfi)


def data_parallel_step(mesh: Mesh, fn, dfi: DeviceFMIndex, axis: str = "data"):
    """Return a jitted step running fn(dfi, batch) with batch sharded over
    the mesh data axis and dfi replicated."""
    rep = NamedSharding(mesh, P())
    shd = NamedSharding(mesh, P(axis))
    dfi_r = replicate_index(mesh, dfi)

    @partial(jax.jit, out_shardings=shd)
    def step(batch):
        return fn(dfi_r, batch)

    def run(batch: jnp.ndarray):
        batch = jax.device_put(batch, shd)
        return step(batch)

    return run

"""Multi-device data parallelism on the virtual CPU mesh."""

import os

import numpy as np
import pytest

from tests.conftest import FIXTURES


def _align_forward_step(dfi, qbatch, match_score=1, window_pad=32):
    """Round-1 demo step (seeding -> SA -> ref fetch -> banded SW) used
    only to exercise data_parallel_step with a real multi-stage
    jittable; the production sharded path is parallel/sharded.py
    (folded here from the retired compseed/pipeline/forward.py)."""
    from functools import partial
    import jax
    import jax.numpy as jnp
    from compseed.ops import fm as dfm
    from compseed.ops import smem as dsmem
    from compseed.ops.bsw import bsw_extend
    from compseed.ops.ref import fetch_windows

    B, L = qbatch.shape
    i32 = jnp.int32
    collect = jax.vmap(partial(dsmem._collect_one, dfi, L))
    packed = collect(qbatch, jnp.zeros(B, i32), jnp.ones(B, i32),
                     jnp.ones(B, jnp.bool_))
    mems = packed[:, : dsmem.MMEM * 5].reshape(B, dsmem.MMEM, 5)
    n_mems = packed[:, dsmem.MMEM * 5].astype(i32)
    valid = jnp.arange(mems.shape[1])[None, :] < n_mems[:, None]
    lens = jnp.where(valid, (mems[:, :, 4] - mems[:, :, 3]).astype(i32), -1)
    best = jnp.argmax(lens, axis=1)
    m = jnp.take_along_axis(mems, best[:, None, None], axis=1)[:, 0, :]
    k, beg, end = m[:, 0], m[:, 3].astype(i32), m[:, 4].astype(i32)
    seed_len = end - beg
    rbeg = dfm.sa_batch(dfi, k)
    W = L + 2 * window_pad
    wbeg = rbeg - beg.astype(rbeg.dtype) - window_pad
    windows = fetch_windows(dfi, wbeg, W)
    from compseed.options import fill_scmat
    mat = jnp.asarray(np.array(fill_scmat(match_score, 4),
                               dtype=np.int32).reshape(5, 5))
    scores, qle, tle, gtle, gscore, max_off = bsw_extend(
        6, 1, 6, 1, 100, 5, match_score, mat, jnp.int32(100),
        qbatch, jnp.full(B, L, i32), windows, jnp.full(B, W, i32),
        jnp.maximum(seed_len * match_score, 1))
    return scores, rbeg, seed_len



def test_data_parallel_step_8dev(tiny_fm):
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import jax.numpy as jnp
    from compseed.ops.device_index import to_device
    from compseed.parallel.mesh import data_parallel_step, make_mesh
    from tests.test_ops_smem import _fixture_queries

    mesh = make_mesh(jax.devices()[:8])
    dfi = to_device(tiny_fm)
    queries = _fixture_queries(16)
    L = max(len(q) for q in queries)
    qarr = np.full((16, L), 4, np.uint8)
    for i, q in enumerate(queries):
        qarr[i, :len(q)] = q
    run = data_parallel_step(mesh, _align_forward_step, dfi)
    scores, rbegs, seed_lens = run(jnp.asarray(qarr))
    assert scores.shape == (16,)
    assert (np.asarray(seed_lens) > 0).all()
    # sharded across all 8 devices
    assert len(scores.sharding.device_set) == 8


def _run_production(fm, mesh, reads):
    """The full production path — sharded seeder, sharded banded-SW
    engine, native tail — over one chunk."""
    import jax
    from compseed.native import NativeTail
    from compseed.options import MemOptions
    from compseed.parallel.sharded import ShardedBswRunner, ShardedSeeder
    from compseed.pipeline.align import align_chunk

    opt = MemOptions()
    seeder = ShardedSeeder(opt, fm, mesh=mesh)
    engine = ShardedBswRunner(opt, np.array(opt.mat), mesh=mesh,
                              dfi=seeder.dfi)
    tail = NativeTail(opt, fm)
    rs = [r.__class__(**r.__dict__) for r in reads]   # fresh copies
    align_chunk(opt, fm, rs, 0, engine=engine, seeder=seeder, tail=tail)
    return "".join(r.sam for r in rs)


@pytest.mark.slow
def test_production_sam_identical_across_mesh_shapes(tiny_fm):
    """The distributed determinism contract (SURVEY §4): byte-identical
    SAM for mesh shapes {1, 2, 4, 8} — the -K reproducibility guarantee
    (main.cpp:266,437) carried to the device mesh."""
    import jax
    from compseed.io.fastq import read_fastq_chunks

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    reads = []
    for chunk in read_fastq_chunks(
            os.path.join(FIXTURES, "reads.fq"), 10**9):
        reads.extend(chunk)
    reads = reads[:240]
    from compseed.parallel.mesh import make_mesh

    sams = {}
    for S in (1, 2, 4, 8):
        mesh = make_mesh(jax.devices()[:S])
        sams[S] = _run_production(tiny_fm, mesh, reads)
    assert sams[1] == sams[2] == sams[4] == sams[8]
    # and the mesh result equals the single-device reference pipeline
    from compseed.native import NativeTail
    from compseed.options import MemOptions
    from compseed.ops.engine import device_engine, device_seeder
    from compseed.pipeline.align import align_chunk

    opt = MemOptions()
    seeder = device_seeder(opt, tiny_fm)
    engine = device_engine(opt, tiny_fm, dfi=seeder.dfi)
    tail = NativeTail(opt, tiny_fm)
    rs = [r.__class__(**r.__dict__) for r in reads]
    align_chunk(opt, tiny_fm, rs, 0, engine=engine, seeder=seeder,
                tail=tail)
    assert sams[8] == "".join(r.sam for r in rs)


@pytest.mark.slow
def test_sharded_meta_path_sam_identical(tiny_fm):
    """The sharded pair interface: ShardedBswRunner.run_meta_dual routes
    each pair to the shard owning its read and slices DP tiles from the
    shard-local read matrix (the GPU kernel under shard_map, interpret
    mode on CPU).  SAM must be byte-identical to the run_flat path."""
    import jax
    from compseed.io.fastq import read_fastq_chunks

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    reads = []
    for chunk in read_fastq_chunks(
            os.path.join(FIXTURES, "reads.fq"), 10**9):
        reads.extend(chunk)
    reads = reads[:160]
    from compseed.native import NativeTail
    from compseed.options import MemOptions
    from compseed.parallel.mesh import make_mesh
    from compseed.parallel.sharded import (ShardedBswRunner,
                                               ShardedSeeder)
    from compseed.pipeline.align import align_chunk

    mesh = make_mesh(jax.devices()[:4])
    sams = {}
    for meta in (False, True):
        opt = MemOptions()
        seeder = ShardedSeeder(opt, tiny_fm, mesh=mesh)
        engine = ShardedBswRunner(opt, np.array(opt.mat), mesh=mesh,
                                  dfi=seeder.dfi, meta=meta, kernel=True)
        tail = NativeTail(opt, tiny_fm)
        rs = [r.__class__(**r.__dict__) for r in reads]
        align_chunk(opt, tiny_fm, rs, 0, engine=engine, seeder=seeder,
                    tail=tail)
        if meta:
            assert engine._meta_steps, "meta path was not exercised"
        sams[meta] = "".join(r.sam for r in rs)
    assert sams[True] == sams[False]


@pytest.mark.slow
def test_sharded_meta_xla_twin_sam_identical(tiny_fm):
    """The sharded meta path with the XLA program as its DP must give
    the same SAM as with the GPU kernel (interpret mode)."""
    import jax
    from compseed.io.fastq import read_fastq_chunks

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    reads = []
    for chunk in read_fastq_chunks(
            os.path.join(FIXTURES, "reads.fq"), 10**9):
        reads.extend(chunk)
    reads = reads[:160]
    from compseed.native import NativeTail
    from compseed.options import MemOptions
    from compseed.parallel.mesh import make_mesh
    from compseed.parallel.sharded import (ShardedBswRunner,
                                               ShardedSeeder)
    from compseed.pipeline.align import align_chunk

    mesh = make_mesh(jax.devices()[:4])
    sams = {}
    for kernel in (True, False):
        opt = MemOptions()
        seeder = ShardedSeeder(opt, tiny_fm, mesh=mesh)
        engine = ShardedBswRunner(opt, np.array(opt.mat), mesh=mesh,
                                  dfi=seeder.dfi, meta=True, kernel=kernel)
        tail = NativeTail(opt, tiny_fm)
        rs = [r.__class__(**r.__dict__) for r in reads]
        align_chunk(opt, tiny_fm, rs, 0, engine=engine, seeder=seeder,
                    tail=tail)
        assert engine._meta_steps, "meta path was not exercised"
        sams[kernel] = "".join(r.sam for r in rs)
    assert sams[True] == sams[False]

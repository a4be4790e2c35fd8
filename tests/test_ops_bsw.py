"""Device banded-SW vs the ksw_extend2 oracle, including pipeline parity."""

import numpy as np
import pytest

from compseed.cpu import ksw
from compseed.options import MemOptions, fill_scmat
from compseed.ops.bsw import BswRunner
from compseed.pipeline.extension import SeqPair


def _random_pairs(rng, n, qmax=100, tmax=200):
    pairs = []
    for _ in range(n):
        tl = int(rng.integers(1, tmax))
        t = rng.integers(0, 4, size=tl).astype(np.uint8)
        ql = int(rng.integers(1, min(qmax, tl + 30)))
        # query = mutated prefix of target (extension-like workload),
        # possibly longer than the target
        q = np.concatenate([t[:ql],
                            rng.integers(0, 4, size=max(ql - tl, 0))
                            .astype(np.uint8)])[:ql].copy()
        for _ in range(int(rng.integers(0, ql // 8 + 1))):
            q[int(rng.integers(0, ql))] = int(rng.integers(0, 4))
        if rng.random() < 0.1:
            q[int(rng.integers(0, ql))] = 4  # ambiguous base
        h0 = int(rng.integers(1, 120))
        pairs.append(SeqPair(qs=q, rs=t, h0=h0, seqid=0, regid=0))
    # degenerate shapes
    pairs.append(SeqPair(qs=np.zeros(1, np.uint8), rs=np.zeros(0, np.uint8),
                         h0=19, seqid=0, regid=0))
    pairs.append(SeqPair(qs=np.zeros(1, np.uint8),
                         rs=np.zeros(300, np.uint8), h0=5, seqid=0, regid=0))
    return pairs


@pytest.mark.parametrize("w,pen_clip", [(100, 5), (200, 5), (10, 0)])
def test_bsw_vs_oracle(w, pen_clip):
    opt = MemOptions()
    mat = np.array(fill_scmat(1, 4))
    rng = np.random.default_rng(31 + w)
    pairs = _random_pairs(rng, 60)
    runner = BswRunner(opt, mat)
    got = runner(pairs, w, pen_clip)
    for i, sp in enumerate(pairs):
        want = ksw.extend(len(sp.qs), sp.qs, len(sp.rs), sp.rs, mat,
                          opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                          w, pen_clip, opt.zdrop, sp.h0)
        assert got[i] == tuple(want), (i, got[i], tuple(want))


@pytest.mark.parametrize("w,pen_clip", [(100, 5), (10, 0)])
def test_bsw_flat_kernel_vs_oracle(w, pen_clip):
    """run_flat through the GPU kernel (its route on the GPU; interpret
    mode here) must equal the ksw_extend2 oracle, one band round."""
    opt = MemOptions()
    mat = np.array(fill_scmat(1, 4))
    pairs = _random_pairs(np.random.default_rng(57 + w), 60)
    runner = BswRunner(opt, mat, kernel=True)
    got = runner(pairs, w, pen_clip)
    for i, sp in enumerate(pairs):
        want = ksw.extend(len(sp.qs), sp.qs, len(sp.rs), sp.rs, mat,
                          opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                          w, pen_clip, opt.zdrop, sp.h0)
        assert got[i] == tuple(want), (i, got[i], tuple(want))


def test_bsw_zdrop_path():
    """Pairs engineered to trigger z-drop / early break."""
    opt = MemOptions()
    mat = np.array(fill_scmat(1, 4))
    rng = np.random.default_rng(77)
    pairs = []
    for _ in range(20):
        t = rng.integers(0, 4, size=180).astype(np.uint8)
        q = np.concatenate([t[:30],
                            rng.integers(0, 4, size=60).astype(np.uint8)])
        pairs.append(SeqPair(qs=q.astype(np.uint8), rs=t, h0=25,
                             seqid=0, regid=0))
    runner = BswRunner(opt, mat)
    got = runner(pairs, 100, 5)
    for i, sp in enumerate(pairs):
        want = ksw.extend(len(sp.qs), sp.qs, len(sp.rs), sp.rs, mat,
                          opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                          100, 5, opt.zdrop, sp.h0)
        assert got[i] == tuple(want), i


def test_pipeline_parity_device_engine(tiny_fm):
    """Device DP engine must give byte-identical SAM to the oracle engine."""
    import os
    from compseed.io.fastq import read_fastq_chunks
    from compseed.pipeline.align import align_chunk
    from compseed.ops.engine import device_engine
    from tests.conftest import FIXTURES

    opt = MemOptions()
    reads = []
    for chunk in read_fastq_chunks(os.path.join(FIXTURES, "reads.fq"),
                                   10_000_000):
        reads.extend(chunk)
    reads = reads[:120]
    align_chunk(opt, tiny_fm, reads, 0, engine=device_engine(opt))
    mine = "".join(r.sam for r in reads).splitlines(keepends=True)
    golden = [l for l in
              open(os.path.join(FIXTURES, "golden_bwamem.sam"))
              if not l.startswith("@")]
    for i, (m, g) in enumerate(zip(mine, golden)):
        assert m == g, f"record {i}:\n{m}\n{g}"


def test_pipeline_parity_dual_engine(tiny_fm):
    """The fused dual-round tail path (NativeTail use_meta: one export →
    bsw_meta_dual → cs_apply_dual per side) must give byte-identical SAM
    to the bwamem golden — covers the on-device band-retry acceptance
    end-to-end."""
    import os
    from compseed.io.fastq import read_fastq_chunks
    from compseed.native import NativeTail
    from compseed.ops.engine import device_seeder
    from compseed.pipeline.align import align_chunk
    from tests.conftest import FIXTURES

    opt = MemOptions()
    reads = []
    for chunk in read_fastq_chunks(os.path.join(FIXTURES, "reads.fq"),
                                   10_000_000):
        reads.extend(chunk)
    reads = reads[:120]
    seeder = device_seeder(opt, tiny_fm)
    engine = BswRunner(opt, np.array(opt.mat), dfi=seeder.dfi, meta=True,
                       kernel=True)
    assert engine.interpret      # the GPU kernel, interpreted on CPU
    tail = NativeTail(opt, tiny_fm)
    align_chunk(opt, tiny_fm, reads, 0, engine=engine, seeder=seeder,
                tail=tail)
    assert engine.prof.get("engine_fetch"), "dual path was not exercised"
    mine = "".join(r.sam for r in reads).splitlines(keepends=True)
    golden = [l for l in
              open(os.path.join(FIXTURES, "golden_bwamem.sam"))
              if not l.startswith("@")]
    for i, (m, g) in enumerate(zip(mine, golden)):
        assert m == g, f"record {i}:\n{m}\n{g}"


def _dual_rounds_ref(opt, mat, queries, qlens, targets, tlens, h0, prev,
                     w):
    """Both band rounds + the acceptance test through the XLA program
    _extend_core, as the host flow runs them (comp_seed.cpp:1732-1767):
    (7, P) int32, the accepted round's six results + the round index."""
    import jax.numpy as jnp
    from compseed.ops.bsw import _extend_core
    from compseed.ops.tiles import clamp_band

    def rnd(band, tl):
        ws = clamp_band(qlens, band, 1, opt.pen_clip5, opt.o_del, opt.e_del,
                        opt.o_ins, opt.e_ins)
        return np.asarray(_extend_core(
            opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop,
            jnp.asarray(mat.reshape(5, 5)), jnp.asarray(ws),
            jnp.asarray(queries), jnp.asarray(qlens), jnp.asarray(targets),
            jnp.asarray(tl), jnp.asarray(h0)))
    out0 = rnd(w, tlens)
    acc = (out0[0] == prev) | (out0[5] < ((w >> 1) + (w >> 2)))
    out1 = rnd(2 * w, np.where(acc, 0, tlens).astype(np.int32))
    return np.concatenate([np.where(acc[None], out0, out1),
                           np.where(acc, 0, 1)[None].astype(np.int32)])


@pytest.mark.parametrize("Q", [128, 256])
def test_bsw_pallas_kernel_vs_xla(Q):
    """The GPU DP kernel (ops/bsw_triton.py, interpret mode on CPU) must
    be bit-identical to the XLA program across random extension
    workloads, in both query-width classes, with both band rounds and
    the acceptance test between them."""
    import jax.numpy as jnp
    from compseed.ops.bsw_triton import BP, bsw_dual_kernel, mat_key
    from compseed.ops.tiles import clamp_band

    opt = MemOptions()
    mat = np.array(fill_scmat(1, 4), dtype=np.int32)
    rng = np.random.default_rng(9 + Q)
    P, T = 2 * BP, 256
    qlens = rng.integers(0, Q - 20, P).astype(np.int32)
    tlens = rng.integers(0, T - 30, P).astype(np.int32)
    queries = np.full((P, Q), 4, np.uint8)
    targets = np.full((P, T), 4, np.uint8)
    for i in range(P):
        queries[i, :qlens[i]] = rng.integers(0, 4, qlens[i])
        tl = int(tlens[i])
        if tl and qlens[i]:
            src = np.resize(queries[i, :qlens[i]], tl).copy()
            err = rng.random(tl) < 0.08
            src[err] = rng.integers(0, 4, err.sum())
            if rng.random() < 0.5:    # an early indel shifts the diagonal
                j = int(rng.integers(0, min(tl, 10)))
                src = np.concatenate([src[:j], src[j + 3:],
                                      rng.integers(0, 4, 3)])[:tl]
            targets[i, :tl] = src
    queries[rng.random((P, Q)) < 0.01] = 4
    h0 = rng.integers(1, 102, P).astype(np.int32)
    w = 4                        # narrow band: many lanes take round 1
    prev = np.full(P, -1, np.int32)
    want = _dual_rounds_ref(opt, mat, queries, qlens, targets, tlens, h0,
                            prev, w)
    prev[::5] = want[0][::5]     # score-unchanged clause accepts these
    want = _dual_rounds_ref(opt, mat, queries, qlens, targets, tlens, h0,
                            prev, w)
    assert 0 < want[6].sum() < P, "both rounds must be exercised"
    meta = np.zeros((8, P), np.int32)
    meta[0], meta[1], meta[2], meta[3] = qlens, tlens, h0, prev
    for r, band in ((4, w), (5, 2 * w)):
        meta[r] = clamp_band(qlens, band, 1, opt.pen_clip5, opt.o_del,
                             opt.e_del, opt.o_ins, opt.e_ins)
    got = np.asarray(bsw_dual_kernel(
        jnp.asarray(queries.T.astype(np.int8)),
        jnp.asarray(targets.T.astype(np.int8)), jnp.asarray(meta),
        mat=mat_key(mat), o_del=opt.o_del, e_del=opt.e_del,
        o_ins=opt.o_ins, e_ins=opt.e_ins, zdrop=opt.zdrop, w0=w,
        interpret=True))
    for j in range(7):
        assert np.array_equal(want[j], got[j]), j


@pytest.mark.parametrize("meta_mode", ["pallas", "xla"])
def test_run_meta_dual_vs_sequential_rounds(micro, meta_mode):
    """run_meta_dual (both band rounds + the retry acceptance fused into
    one device program, ops/bsw.py::bsw_meta_dual; "pallas" = the GPU
    kernel interpreted, "xla" = the XLA program) must equal the
    sequential two-round flow: round 0 at w, accept where score==prev or
    max_off < (w>>1)+(w>>2) (comp_seed.cpp:1732-1767), round 1 at 2w for
    the rest."""
    import jax.numpy as jnp
    from compseed.ops.device_index import to_device

    seq, built, fm = micro
    dfi = to_device(fm)
    from compseed.index.build import unpack_pac
    pac = unpack_pac(fm.pac, fm.l_pac)
    l_pac = int(dfi.l_pac)
    opt = MemOptions()
    mat = np.array(fill_scmat(1, 4), dtype=np.int32)
    rng = np.random.default_rng(123)

    R, L = 16, 256
    qarr = np.full((R, L), 4, np.uint8)
    for i in range(R):
        rl = int(rng.integers(40, 200))
        qarr[i, :rl] = rng.integers(0, 4, rl)

    n = 200
    qmeta = np.zeros((n, 4), np.int32)
    rmeta = np.zeros((n, 2), np.int64)
    h0 = np.zeros(n, np.int32)
    qbuf, rbuf = [], []
    for p in range(n):
        rid = int(rng.integers(0, R))
        rev = int(rng.integers(0, 2))
        qlen = int(rng.integers(1, 129))
        if rev == 0:
            q0 = int(rng.integers(0, L - qlen + 1))
            q = qarr[rid, q0: q0 + qlen].copy()
        else:
            q0 = int(rng.integers(qlen - 1, L))
            q = qarr[rid, q0 - qlen + 1: q0 + 1][::-1].copy()
        tlen = 0 if p == 11 else int(rng.integers(1, 180))
        if rev == 0:
            r0 = int(rng.integers(0, 2 * l_pac - tlen))
            gp = r0 + np.arange(tlen)
        else:
            r0 = int(rng.integers(tlen - 1, 2 * l_pac)) if tlen else 0
            gp = r0 - np.arange(tlen)
        fwd = gp < l_pac
        pf = np.where(fwd, gp, 2 * l_pac - 1 - gp)
        t = np.where(fwd, pac[pf], 3 - pac[pf]).astype(np.uint8)
        qmeta[p] = (rid, q0, qlen, rev)
        rmeta[p] = (r0, tlen)
        h0[p] = int(rng.integers(1, 120))
        qbuf.append(q)
        rbuf.append(t)

    qoff = np.zeros(n + 1, np.int64)
    roff = np.zeros(n + 1, np.int64)
    np.cumsum([len(q) for q in qbuf], out=qoff[1:])
    np.cumsum([len(t) for t in rbuf], out=roff[1:])
    flat_q = np.concatenate(qbuf)
    flat_r = np.concatenate(rbuf) if roff[-1] else np.zeros(0, np.uint8)

    rx = BswRunner(opt, mat)
    w = 8   # narrow nominal band => many retries exercise round 1
    pen = opt.pen_clip5
    out0 = rx.run_flat(flat_q, qoff, flat_r, roff, h0, w, pen)
    out1 = rx.run_flat(flat_q, qoff, flat_r, roff, h0, 2 * w, pen)
    # prev: mix of -1 (fresh left ext) and == score0 (side-1-like, must
    # accept round 0 via the score-unchanged clause even with max_off big)
    prev = np.full(n, -1, np.int32)
    prev[::5] = out0[0][::5]
    accept0 = (out0[0] == prev) | (out0[5] < ((w >> 1) + (w >> 2)))
    want = [np.where(accept0, out0[j], out1[j]) for j in range(6)]
    want.append(np.where(accept0, 0, 1).astype(np.int32))

    rm = BswRunner(opt, mat, dfi=dfi, meta=True,
                   kernel=meta_mode == "pallas")
    rm.set_query_context(jnp.asarray(qarr), L)
    assert rm.supports_meta
    got = rm.run_meta_dual(qmeta, rmeta, h0, prev, w, pen)
    for j in range(7):
        assert np.array_equal(want[j], got[j]), j


@pytest.mark.parametrize("meta_mode", ["pallas", "xla"])
def test_run_meta_class_split_interpret(micro, meta_mode):
    """run_meta_dual's Q-class split must equal run_flat (XLA) on
    metadata-described pairs spanning two query-length classes — covers
    the on-device tile slicing AND the per-class dispatch, for both
    DPs: the GPU kernel (interpret mode) and the XLA program."""
    import jax.numpy as jnp
    from compseed.ops.device_index import to_device

    seq, built, fm = micro
    dfi = to_device(fm)
    from compseed.index.build import unpack_pac
    pac = unpack_pac(fm.pac, fm.l_pac)   # mirrored pf is always < l_pac
    l_pac = int(dfi.l_pac)
    opt = MemOptions()
    mat = np.array(fill_scmat(1, 4), dtype=np.int32)
    rng = np.random.default_rng(77)

    R, L = 24, 256
    qarr = np.full((R, L), 4, np.uint8)
    for i in range(R):
        rl = int(rng.integers(40, 200))
        qarr[i, :rl] = rng.integers(0, 4, rl)
        # sprinkle ambiguous bases
        amb = rng.random(rl) < 0.02
        qarr[i, :rl][amb] = 4

    n = 300
    qmeta = np.zeros((n, 4), np.int32)
    rmeta = np.zeros((n, 2), np.int64)
    h0 = np.zeros(n, np.int32)
    qbuf, rbuf = [], []
    for p in range(n):
        rid = int(rng.integers(0, R))
        rev = int(rng.integers(0, 2))
        # ~1/3 long queries to force a second Q class (>128)
        qlen = int(rng.integers(129, 201)) if p % 3 == 0 else \
            int(rng.integers(1, 129))
        if rev == 0:
            q0 = int(rng.integers(0, L - qlen + 1))
            q = qarr[rid, q0: q0 + qlen].copy()
        else:
            q0 = int(rng.integers(qlen - 1, L))
            q = qarr[rid, q0 - qlen + 1: q0 + 1][::-1].copy()
        tlen = 0 if p == 17 else int(rng.integers(1, 180))
        if rev == 0:
            r0 = int(rng.integers(0, 2 * l_pac - tlen))
            gp = r0 + np.arange(tlen)
        else:
            r0 = int(rng.integers(tlen - 1, 2 * l_pac)) if tlen else 0
            gp = r0 - np.arange(tlen)
        fwd = gp < l_pac
        pf = np.where(fwd, gp, 2 * l_pac - 1 - gp)
        t = np.where(fwd, pac[pf], 3 - pac[pf]).astype(np.uint8)
        qmeta[p] = (rid, q0, qlen, rev)
        rmeta[p] = (r0, tlen)
        h0[p] = int(rng.integers(1, 120))
        qbuf.append(q)
        rbuf.append(t)

    qoff = np.zeros(n + 1, np.int64)
    roff = np.zeros(n + 1, np.int64)
    np.cumsum([len(q) for q in qbuf], out=qoff[1:])
    np.cumsum([len(t) for t in rbuf], out=roff[1:])
    flat_q = np.concatenate(qbuf)
    flat_r = np.concatenate(rbuf) if roff[-1] else np.zeros(0, np.uint8)

    rx = BswRunner(opt, mat)
    want = rx.run_flat(flat_q, qoff, flat_r, roff, h0, opt.w, opt.pen_clip5)
    # prev == the round-0 score: every pair accepts round 0
    prev = want[0]

    rm = BswRunner(opt, mat, dfi=dfi, meta=True,
                   kernel=meta_mode == "pallas")
    rm.set_query_context(jnp.asarray(qarr), L)
    assert rm.supports_meta
    got = rm.run_meta_dual(qmeta, rmeta, h0, prev, opt.w, opt.pen_clip5)
    assert not got[6].any()
    for j in range(6):
        assert np.array_equal(want[j], got[j]), j


def test_build_tiles_packed_equals_ref(micro):
    """The packed-word tile build (word gathers + fold-branch decode)
    must be bit-exact vs the per-element reference formulation for
    forward/reverse pairs on both strands, including windows straddling
    the strand mirror and row-end padding."""
    import jax.numpy as jnp

    from compseed.index.build import unpack_pac
    from compseed.ops.tiles import build_tiles, build_tiles_ref
    from compseed.ops.device_index import to_device

    seq, built, fm = micro
    dfi = to_device(fm)
    l_pac = int(dfi.l_pac)
    rng = np.random.default_rng(31)
    R, L = 24, 128
    qarr = np.full((R, L), 4, np.uint8)
    for i in range(R):
        ln = int(rng.integers(40, L - 1))
        qarr[i, :ln] = rng.integers(0, 5, ln)   # includes Ns
    Q, T = 128, 256
    n = 257                                     # odd, off-bucket
    qmeta = np.zeros((n, 4), np.int32)
    r0 = np.zeros(n, np.int64)
    rlen = np.zeros(n, np.int32)
    for p in range(n):
        rid = int(rng.integers(0, R))
        rev = int(rng.integers(0, 2))
        ql = int(rng.integers(1, 120))
        q0 = int(rng.integers(0, L - ql)) if rev == 0 else \
            int(rng.integers(ql - 1, L))
        tl = int(rng.integers(0, 180))
        if rev == 0:
            r0[p] = int(rng.integers(0, max(2 * l_pac - tl, 1)))
        else:
            r0[p] = int(rng.integers(max(tl - 1, 0), 2 * l_pac))
        qmeta[p] = (rid, q0, ql, rev)
        rlen[p] = tl
    qflat = jnp.asarray(qarr.reshape(-1))
    qm = jnp.asarray(qmeta)
    r0j = jnp.asarray(r0)
    rl = jnp.asarray(rlen)
    a = build_tiles_ref(qflat, dfi.pac_words, qm, r0j, rl,
                        Q=Q, T=T, L=L, l_pac=l_pac)
    b = build_tiles(qflat, dfi.pac_words, qm, r0j, rl,
                    Q=Q, T=T, L=L, l_pac=l_pac)
    assert np.array_equal(np.asarray(a[0]), np.asarray(b[0]))  # qt
    assert np.array_equal(np.asarray(a[1]), np.asarray(b[1]))  # ql
    assert np.array_equal(np.asarray(a[2]), np.asarray(b[2]))  # tt

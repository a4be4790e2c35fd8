"""Device-resident v2 seeder vs the host seeding oracle.

Same contract as test_ops_smem (matches + resolved seeds identical per
read), exercised through the dense-worklist pipeline: forward pivot scan,
independent backward walks with staged compaction, device reconstruction,
rounds 2/3, sampling and merged SAL.
"""

import os

import numpy as np

from compseed.options import MemOptions
from compseed.pipeline import seeding
from compseed.pipeline.align import encode_read
from compseed.ops.seeder2 import DeviceSeeder

from tests.conftest import FIXTURES


def _fixture_queries(n):
    from compseed.io.fastq import read_fastq_chunks
    reads = []
    for chunk in read_fastq_chunks(os.path.join(FIXTURES, "reads.fq"),
                                   10_000_000):
        reads.extend(chunk)
    return [encode_read(r.seq) for r in reads[:n]]


def test_seeder2_matches_oracle(tiny_fm):
    opt = MemOptions()
    queries = _fixture_queries(48)
    seeder = DeviceSeeder(opt, tiny_fm)
    got = seeder(tiny_fm, opt, queries)
    assert not seeder.last_overflow
    for r, q in enumerate(queries):
        want = seeding.collect_matches(tiny_fm, opt, q)
        assert got[r][0] == want, f"read {r}"
    want_seeds = [seeding.sample_seeds(opt, seeding.collect_matches(
        tiny_fm, opt, q)) for q in queries]
    seeding.resolve_sal(tiny_fm, want_seeds)
    for r in range(len(queries)):
        g = [(s.rbeg, s.qbeg, s.len) for s in got[r][1]]
        w = [(s.rbeg, s.qbeg, s.len) for s in want_seeds[r]]
        assert g == w, f"read {r} seeds differ"


def test_seeder2_edge_cases(tiny_fm):
    """Ns, all-N, short reads, N at both ends."""
    opt = MemOptions()
    rng = np.random.default_rng(41)
    base_qs = _fixture_queries(6)
    queries = []
    for q in base_qs:
        q = q.copy()
        for _ in range(3):
            q[int(rng.integers(0, len(q)))] = 4
        queries.append(q)
    queries.append(np.full(50, 4, dtype=np.uint8))
    queries.append(base_qs[0][:37].copy())
    queries.append(base_qs[1][:19].copy())
    queries.append(base_qs[2][:5].copy())
    qq = base_qs[3].copy()
    qq[0] = 4
    qq[-1] = 4
    queries.append(qq)
    seeder = DeviceSeeder(opt, tiny_fm)
    got = seeder(tiny_fm, opt, queries)
    for r, q in enumerate(queries):
        want = seeding.collect_matches(tiny_fm, opt, q)
        assert got[r][0] == want, f"read {r}"


def test_seeder2_run_flat_contract(tiny_fm):
    """run_flat output must agree with the legacy lockstep seeder."""
    from compseed.ops.smem import BatchSeeder
    opt = MemOptions()
    queries = _fixture_queries(32)
    v2 = DeviceSeeder(opt, tiny_fm)
    v1 = BatchSeeder(opt, tiny_fm, v2.dfi)
    l2, s2, so2 = v2.run_flat(queries)
    l1, s1, so1 = v1.run_flat(queries)
    assert np.array_equal(l1, l2)
    assert np.array_equal(so1, so2)
    assert np.array_equal(s1, s2)


def test_seeder2_dedup_matches_oracle(tiny_fm):
    """Cross-read walk dedup (the compressive SST reuse) must not change
    results — identical matches on a sorted (reordered-style) batch,
    with the query-vs-call counters showing actual merging."""
    from compseed.pipeline.seeding import SeedingStats

    opt = MemOptions()
    queries = sorted(_fixture_queries(64), key=lambda q: q.tobytes())
    sd = DeviceSeeder(opt, tiny_fm, dedup=True)
    got = sd(tiny_fm, opt, queries)
    assert not sd.last_overflow
    for r, q in enumerate(queries):
        want = seeding.collect_matches(tiny_fm, opt, q)
        assert got[r][0] == want, f"read {r}"
    st = SeedingStats()
    sd.run_flat(queries, st)
    assert st.bwt_calls <= st.bwt_queries


def test_seeder2_int64_index_path(tiny_fm):
    """Force the int64 device index (what hg19-scale genomes use) and
    require identical seeding results."""
    import numpy as np
    from compseed.ops.device_index import to_device

    opt = MemOptions()
    queries = _fixture_queries(24)
    dfi64 = to_device(tiny_fm, force_dtype=np.int64)
    assert dfi64.dtype.__name__ == "int64" or str(dfi64.dtype) == \
        "<class 'jax.numpy.int64'>" or True  # dtype property sanity below
    import jax.numpy as jnp
    assert dfi64.dtype == jnp.int64
    sd = DeviceSeeder(opt, tiny_fm, dfi=dfi64)
    got = sd(tiny_fm, opt, queries)
    for r, q in enumerate(queries):
        want = seeding.collect_matches(tiny_fm, opt, q)
        assert got[r][0] == want, f"read {r}"


def test_seeder2_per_read_fallback(tiny_fm):
    """A read that overflows its per-read device buffers (a long read
    pushes more LEPs than the scan cap) is recomputed with the oracle
    and spliced in; the rest of the chunk keeps its device results."""
    import numpy as np

    opt = MemOptions()
    queries = _fixture_queries(8)
    rng = np.random.default_rng(3)
    long_read = rng.integers(0, 4, 480).astype(np.uint8)  # LEPs >> CAPL
    queries.insert(3, long_read)
    sd = DeviceSeeder(opt, tiny_fm)
    l2, s2, so2 = sd.run_flat(queries)
    assert not sd.last_overflow  # chunk-global caps did NOT trip
    from compseed.pipeline.chain import l_rep_one
    for r, q in enumerate(queries):
        want = seeding.collect_matches(tiny_fm, opt, q)
        wrep = l_rep_one([(b, e, s) for (_, _, s, b, e) in want],
                         opt.max_occ)
        assert int(l2[r]) == wrep, f"read {r}"
        wseeds = seeding.sample_seeds(opt, want)
        seeding.resolve_sal(tiny_fm, [wseeds])
        got = [tuple(int(x) for x in row) for row in s2[so2[r]:so2[r + 1]]]
        assert got == [(x.rbeg, x.qbeg, x.len) for x in wseeds], f"read {r}"


def _pool_from_scan(dfi, qarr, rlens, GP):
    import jax.numpy as jnp
    import numpy as np
    from compseed.ops import seedscan as ss

    scan1 = ss.make_scan(dfi, qarr.shape[1], ss.CAPL, advance=True)
    lep, cnt, sovf = scan1(jnp.asarray(qarr), jnp.asarray(rlens),
                           jnp.zeros(len(rlens), jnp.int32),
                           jnp.ones(len(rlens), jnp.int32),
                           jnp.asarray(rlens) > 0)
    assert not np.asarray(sovf).any()
    return np.asarray(ss.build_pool(lep, cnt, GP)[0])


def test_forward_scan_dedup_exact(tiny_fm):
    """The staged forward-sweep worklist with cross-read dedup (the
    forward SST, mapping/SST.h:60-71) must emit the exact LEP pool of
    the lockstep scan, for adversarial reads: Ns, short reads, exact
    duplicates, shared prefixes, overlapping coverage."""
    import jax.numpy as jnp
    import numpy as np
    from compseed.ops import seedscan as ss
    from compseed.ops.device_index import to_device

    dfi = to_device(tiny_fm)
    rng = np.random.default_rng(21)
    from tests.conftest import FIXTURES
    import os
    from compseed.index.build import read_fasta
    from compseed.utils import NT4_TABLE
    g = read_fasta(os.path.join(FIXTURES, "tiny.fa"))[0][2]
    gcodes = NT4_TABLE[np.frombuffer(g, np.uint8)]

    def sub(p, n):
        return list(int(x) for x in gcodes[p:p + n])

    reads = []
    base = sub(12000, 101)
    for i in range(40):                      # near-duplicates
        r = list(base)
        if i % 3:
            r[int(rng.integers(0, 101))] = int(rng.integers(0, 4))
        reads.append(r)
    for i in range(60):                      # overlapping coverage
        p = int(rng.integers(30000, 31000))
        r = sub(p, 101)
        if i % 2:
            r[int(rng.integers(0, 101))] = int(rng.integers(0, 4))
        reads.append(r)
    reads.append(list(rng.integers(0, 4, 30)))          # short
    reads.append([4] * 25)                              # all N
    r = list(rng.integers(0, 4, 90))
    r[40:43] = [4, 4, 4]                                # interior Ns
    reads.append(r)
    reads.append([])                                    # empty
    reads.sort()
    R, L = 128, 128
    qarr = np.full((R, L), 4, np.uint8)
    rlens = np.zeros(R, np.int32)
    for i, q in enumerate(reads):
        qarr[i, :len(q)] = q
        rlens[i] = len(q)
    GP = 48 * R
    pool0 = _pool_from_scan(dfi, qarr, rlens, GP)
    stages = [(R, 8), (R, 8), (R, 16), (R, 32), (R, 64),
              (R, L + 2), (R, L + 2)]
    pool1, n1, ovf, fq, fc = ss.forward_scan_dedup(
        dfi, jnp.asarray(qarr), jnp.asarray(rlens), GP, stages)
    assert not bool(ovf)
    a = pool0[pool0[:, 6] != 0]
    b = np.asarray(pool1)[np.asarray(pool1)[:, 6] != 0]
    assert len(a) == len(b) and np.array_equal(a, b)
    # the duplicated reads must actually share representative walks
    assert int(fc) < int(fq)


def test_forward_scan_dedup_l_domain_key(tiny_fm):
    """Forward-sweep group keys must be exact for the FORWARD dynamics.

    ``extend_batch(is_back=False)`` ranks at x = ik[1] (the l coordinate,
    ops/fm.py:91-95): a forward step's sizes — hence every stop/push
    decision — are functions of (l, s), while k only accumulates shared
    deltas.  Two mid-sweep lanes can share (k, s) AND upcoming content
    while one's consumed string is a right-extension of the other's
    (interval(X) == interval(X·Z) whenever every X occurrence continues
    with Z), yet their l values — interval(revcomp) — differ, so their
    futures diverge.  Keying the group on (k, s) merges them and corrupts
    the pool; the key must use (l, s) with k delta-adjusted per member
    (the exact mirror of the backward dedup's l adjustment,
    seeder2.py::j_round1).

    Construction: genome where "AC" occurs exactly twice, both times
    followed by "GG" (and no "GT" anywhere, so the revcomp strand adds no
    occurrence).  Junk prefixes of lengths 7/5 make lane1 die+respawn so
    it has consumed exactly "AC" and lane2 exactly "ACGG" at the same
    stage boundary with identical remaining read content: same (k, s),
    same window hash, different l, divergent futures.
    """
    import jax.numpy as jnp
    import numpy as np
    from compseed.cpu import fm_oracle as fo
    from compseed.ops import seedscan as ss
    from compseed.utils import NT4_TABLE
    from tests.conftest import _index_from_codes

    def codes(s):
        return NT4_TABLE[np.frombuffer(s.encode(), np.uint8)].copy()

    B1, B2 = "ACGGGA", "ACGGAA"
    J1, J2 = "CTCTCTC", "CTCTC"
    genome = B1 + B2 + "TT" + J1 + "TT" + J2 + "TT" + "TA" * 48
    assert genome.count("AC") == 2 and "GT" not in genome
    _, _, fm = _index_from_codes(codes(genome))

    # oracle check of the mechanism: same (k, s), different l
    def fwd_state(pat):
        q = codes(pat)
        ik = fo.set_intv(fm, int(q[0]))
        for c in q[1:]:
            ik = fo.extend(fm, ik, 0)[3 - int(c)]
        return ik

    st1, st2 = fwd_state("AC"), fwd_state("ACGG")
    assert st1[0] == st2[0] and st1[2] == st2[2], "construction: same (k,s)"
    assert st1[1] != st2[1], "construction: different l"

    W = "GA" + "TCCA" * 4
    read1 = codes(J1 + "AC" + W)
    read2 = codes(J2 + "ACGG" + W)
    R, L = 8, 32
    qarr = np.full((R, L), 4, np.uint8)
    rlens = np.zeros(R, np.int32)
    for i, q in enumerate([read1, read2]):
        qarr[i, :len(q)] = q
        rlens[i] = len(q)
    from compseed.ops.device_index import to_device
    dfi = to_device(fm)
    GP = 48 * R
    pool0 = _pool_from_scan(dfi, qarr, rlens, GP)
    stages = [(R, 8), (R, 8), (R, 16), (R, L + 2), (R, L + 2)]
    pool1, n1, ovf, fq, fc = ss.forward_scan_dedup(
        dfi, jnp.asarray(qarr), jnp.asarray(rlens), GP, stages)
    assert not bool(ovf)
    a = pool0[pool0[:, 6] != 0]
    b = np.asarray(pool1)[np.asarray(pool1)[:, 6] != 0]
    assert len(a) == len(b) and np.array_equal(a, b)


def test_forward_scan_dedup_overflow_flag(tiny_fm):
    """Caps below the unique-group count must raise the overflow flag
    (the caller falls back to the exact path)."""
    import jax.numpy as jnp
    import numpy as np
    from compseed.ops import seedscan as ss
    from compseed.ops.device_index import to_device
    from tests.test_seeder2 import _fixture_queries

    dfi = to_device(tiny_fm)
    queries = _fixture_queries(64)
    R, L = 64, 128
    qarr = np.full((R, L), 4, np.uint8)
    rlens = np.zeros(R, np.int32)
    for i, q in enumerate(queries):
        qarr[i, :len(q)] = q
        rlens[i] = len(q)
    stages = [(R // 8, 8), (R // 8, L + 2), (R // 8, L + 2),
              (R // 8, L + 2)]
    _, _, ovf, _, _ = ss.forward_scan_dedup(
        dfi, jnp.asarray(qarr), jnp.asarray(rlens), 48 * R, stages)
    assert bool(ovf)


def test_forward_dedup_adaptive_disable(tiny_fm, monkeypatch):
    """A forward-cap overflow must (a) fall back to exact results for
    that chunk and (b) disable the forward path for subsequent chunks
    instead of overflowing every time.  (Staged engine only: the chain
    memo's caps are lossy, not overflowing.)"""
    import numpy as np
    from compseed.ops import seedscan as ss

    monkeypatch.setenv("COMPSEED_FWD_MEMO", "0")
    opt = MemOptions()
    queries = _fixture_queries(48)
    # force-overflow caps: one rep lane, tiny budgets
    monkeypatch.setattr(ss, "fwd_stages_for",
                        lambda R, L: [(1, 8), (1, L + 2), (1, L + 2)])
    sd = DeviceSeeder(opt, tiny_fm, dedup=True)
    assert not sd.fwd_disabled
    l1, s1, so1 = sd.run_flat(queries)
    assert sd.last_overflow          # chunk fell back...
    assert sd.fwd_disabled           # ...and the path self-disabled
    l2, s2, so2 = sd.run_flat(queries)
    assert not sd.last_overflow      # non-fwd path, no overflow
    assert np.array_equal(l1, l2) and np.array_equal(s1, s2)
    from compseed.pipeline.chain import l_rep_one
    for r, q in enumerate(queries):
        want = seeding.collect_matches(tiny_fm, opt, q)
        wrep = l_rep_one([(b, e, s) for (_, _, s, b, e) in want],
                         opt.max_occ)
        assert int(l2[r]) == wrep, f"read {r}"

def test_chain_scan_r1_exact(tiny_fm):
    """The cross-round extension-chain memo (ss.chain_scan, the device
    rendering of the forward SST trie) must emit the exact LEP pool of
    the lockstep scan on adversarial reads: Ns, short reads, exact
    duplicates, offset-shifted overlaps, mixed lengths."""
    import jax.numpy as jnp
    from compseed.ops import seedscan as ss
    from compseed.ops.device_index import to_device

    dfi = to_device(tiny_fm)
    rng = np.random.default_rng(11)
    queries = _fixture_queries(24)
    extra = []
    q0 = queries[0].copy()
    q0[10] = 4
    q0[11] = 4
    extra.append(q0)                       # adjacent Ns
    extra.append(queries[1][:23].copy())   # short
    extra.append(queries[2].copy())        # exact duplicate
    e2 = queries[2][7:80].copy()
    extra.append(e2)                       # offset-shifted overlap
    allq = queries + extra
    R = len(allq)
    L = 128
    qarr = np.full((R, L), 4, np.uint8)
    rlens = np.zeros(R, np.int32)
    for i, q in enumerate(allq):
        qarr[i, :len(q)] = q
        rlens[i] = len(q)

    from tests.test_seeder2 import _pool_from_scan
    GP = 48 * R
    pool0 = _pool_from_scan(dfi, qarr, rlens, GP)
    memo = ss.make_chain_memo(1 << 14, 4096, ss.CHAIN_W, dfi.dtype)
    pool1, n1, ovf, fq, fc, memo = ss.chain_scan(
        dfi, jnp.asarray(qarr), jnp.asarray(rlens), GP, memo)
    assert not bool(ovf)
    a = pool0[pool0[:, 6] != 0]
    b = np.asarray(pool1)[np.asarray(pool1)[:, 6] != 0]
    assert len(a) == len(b) and np.array_equal(a, b)
    # the duplicate + overlap reads must produce memo hits
    assert int(fc) < int(fq)


def test_chain_memo_cross_round_reuse(tiny_fm):
    """One chain memo serves all three seeding rounds: stops are
    lane-side (min_hits, greedy round-3 rule), so round 3's greedy
    re-walk of the same content consumes round 1's chains.  Run the
    full seeder with COMPSEED_FWD_MEMO=1: results must equal the
    oracle and the r3 pass must add almost no fresh chain walks for
    duplicate reads."""
    import jax.numpy as jnp
    from compseed.ops import seedscan as ss
    from compseed.ops.device_index import to_device

    dfi = to_device(tiny_fm)
    queries = _fixture_queries(16)
    R, L = 16, 128
    qarr = np.full((R, L), 4, np.uint8)
    rlens = np.zeros(R, np.int32)
    for i, q in enumerate(queries):
        qarr[i, :len(q)] = q
        rlens[i] = len(q)
    qd, rd = jnp.asarray(qarr), jnp.asarray(rlens)
    GP = 48 * R
    memo = ss.make_chain_memo(1 << 15, 8192, ss.CHAIN_W, dfi.dtype)
    _, _, ovf1, fq1, fc1, memo = ss.chain_scan(dfi, qd, rd, GP, memo)
    assert not bool(ovf1)
    ents_after_r1 = int(memo["cur"])
    # r3 greedy over the same reads, same memo
    opt = MemOptions()
    _, _, ovf3, fq3, fc3, memo = ss.chain_scan(
        dfi, qd, rd, GP, memo, mode="r3",
        min_len=opt.min_seed_len, max_intv=int(opt.max_mem_intv))
    assert not bool(ovf3)
    # round 3 walks content round 1 paid for: its fresh chain walks must
    # stay below its consumed steps even on this low-redundancy fixture
    # (on the 30x bench input the r1+r3 reuse reaches ~35%)
    assert int(fc3) < int(fq3), (int(fc3), int(fq3))
    assert int(memo["cur"]) > ents_after_r1  # r3 also contributes chains


def test_chain_memo_full_seeder_differential(tiny_fm, monkeypatch):
    """COMPSEED_FWD_MEMO=1 through the whole DeviceSeeder: matches must
    equal the scalar oracle for every read (sorted, reordered-style
    batch) and the stats counters must show reuse."""
    monkeypatch.setenv("COMPSEED_FWD_MEMO", "1")
    from compseed.pipeline.seeding import SeedingStats

    opt = MemOptions()
    queries = sorted(_fixture_queries(64), key=lambda q: q.tobytes())
    sd = DeviceSeeder(opt, tiny_fm, dedup=True)
    assert sd.fwd_memo
    got = sd(tiny_fm, opt, queries)
    assert not sd.last_overflow
    for r, q in enumerate(queries):
        want = seeding.collect_matches(tiny_fm, opt, q)
        assert got[r][0] == want, f"read {r}"
    st = SeedingStats()
    sd.run_flat(queries, st)
    assert st.bwt_calls < st.bwt_queries


def test_chain_memo_lossy_caps_stay_exact(tiny_fm):
    """Unlike every other cap, the chain memo degrades GRACEFULLY: a
    full chain store stops inserting and hash-slot evictions only lose
    reuse — results must stay exact with no overflow flag even at
    absurdly small caps."""
    import jax.numpy as jnp
    from compseed.ops import seedscan as ss
    from compseed.ops.device_index import to_device

    dfi = to_device(tiny_fm)
    queries = _fixture_queries(32)
    R, L = 32, 128
    qarr = np.full((R, L), 4, np.uint8)
    rlens = np.zeros(R, np.int32)
    for i, q in enumerate(queries):
        qarr[i, :len(q)] = q
        rlens[i] = len(q)
    from tests.test_seeder2 import _pool_from_scan
    GP = 48 * R
    pool0 = _pool_from_scan(dfi, qarr, rlens, GP)
    memo = ss.make_chain_memo(32, 16, ss.CHAIN_W, dfi.dtype)  # tiny
    pool1, n1, ovf, fq, fc, memo = ss.chain_scan(
        dfi, jnp.asarray(qarr), jnp.asarray(rlens), GP, memo)
    assert not bool(ovf)
    a = pool0[pool0[:, 6] != 0]
    b = np.asarray(pool1)[np.asarray(pool1)[:, 6] != 0]
    assert len(a) == len(b) and np.array_equal(a, b)


def test_windowed_bwd_dedup_captures_shifted_sharing(tiny_fm, monkeypatch):
    """Overlapping reads SHIFTED against each other hold the same
    (interval, content-window) backward states at different pivots.
    The windowed dedup (walk_pool_dedup) must (a) produce bit-identical
    seeding results to the whole-walk keying and (b) actually share
    steps (bc1 well below bq1), which position-keyed dedup cannot."""
    import jax.numpy as jnp
    from compseed.index.build import unpack_pac
    from compseed.options import MemOptions
    from compseed.ops.seeder2 import DeviceSeeder

    g = unpack_pac(tiny_fm.pac, tiny_fm.l_pac)
    rng = np.random.default_rng(11)
    R, L = 256, 128
    qa = np.full((R, L), 4, np.uint8)
    rl = np.zeros(R, np.int32)
    base = int(rng.integers(0, len(g) - 4000))
    for i in range(R):   # 30x-style overlap: shifted windows, rare errors
        p = base + int(rng.integers(0, 800))
        r = g[p: p + 101].copy()
        if rng.random() < 0.3:
            r[int(rng.integers(0, 101))] = int(rng.integers(0, 4))
        qa[i, :101] = r
        rl[i] = 101
    qd, rd = jnp.asarray(qa), jnp.asarray(rl)

    outs = {}
    monkeypatch.setenv("COMPSEED_BWD_CHAIN", "0")   # pin the r4 engines
    for win in ("0", "1"):
        monkeypatch.setenv("COMPSEED_BWD_WIN", win)
        sd = DeviceSeeder(MemOptions(), tiny_fm, dedup=True)
        fns = sd._build(R, L)
        (pool, ok, rid, k, l, s, beg, end, ovf1, bad1, n_pool, n_u,
         fqc, fcc, bq1, bc1, memo) = fns["r1"](sd.dfi, qd, rd)
        assert not np.asarray(ovf1).any()
        outs[win] = dict(
            ok=np.asarray(ok), rid=np.asarray(rid), k=np.asarray(k),
            s=np.asarray(s), beg=np.asarray(beg), end=np.asarray(end),
            bq=int(bq1), bc=int(bc1))
    a, b = outs["0"], outs["1"]
    assert np.array_equal(a["ok"], b["ok"])
    m = a["ok"]          # non-emitted lanes carry don't-care values
    for f in ("rid", "k", "s", "beg", "end"):
        assert np.array_equal(a[f][m], b[f][m]), f
    assert a["bq"] == b["bq"]
    # the windowed key is position-independent, so it must share at
    # least as many steps as whole-walk keying, and strictly more here
    # (measured r4: state-level backward sharing is small on shifted
    # coverage — sweep pivots inherit the read-start phase, for the
    # reference's trie too — see EVIDENCE/reuse_attribution.md)
    assert b["bc"] < b["bq"], (b["bc"], b["bq"])
    assert b["bc"] < a["bc"], (b["bc"], a["bc"])


def test_bwd_chain_rounds_bit_exact(tiny_fm, monkeypatch):
    """The chained-round backward walker (walk_pool_chain) must produce
    bit-identical round-1 seeding results to both r4 engines (windowed
    probe + staged walk, and whole-walk keying) on shifted-coverage
    input, with the same query count and real sharing (bc < bq)."""
    import jax.numpy as jnp
    from compseed.index.build import unpack_pac
    from compseed.options import MemOptions
    from compseed.ops.seeder2 import DeviceSeeder

    g = unpack_pac(tiny_fm.pac, tiny_fm.l_pac)
    rng = np.random.default_rng(13)
    R, L = 256, 128
    qa = np.full((R, L), 4, np.uint8)
    rl = np.zeros(R, np.int32)
    base = int(rng.integers(0, len(g) - 4000))
    for i in range(R):
        p = base + int(rng.integers(0, 800))
        r = g[p: p + 101].copy()
        if rng.random() < 0.3:
            r[int(rng.integers(0, 101))] = int(rng.integers(0, 4))
        if rng.random() < 0.05:
            r[int(rng.integers(0, 101))] = 4        # N death path
        qa[i, :101] = r
        rl[i] = 101
    # a read with an all-N prefix (pivot-0 fast path, death == -1)
    qa[3, :40] = 4
    qd, rd = jnp.asarray(qa), jnp.asarray(rl)

    outs = {}
    for mode, env in (("chain", {"COMPSEED_BWD_CHAIN": "1"}),
                      ("win", {"COMPSEED_BWD_CHAIN": "0",
                               "COMPSEED_BWD_WIN": "1"}),
                      ("whole", {"COMPSEED_BWD_CHAIN": "0",
                                 "COMPSEED_BWD_WIN": "0"})):
        for kk, vv in env.items():
            monkeypatch.setenv(kk, vv)
        sd = DeviceSeeder(MemOptions(), tiny_fm, dedup=True)
        fns = sd._build(R, L)
        (pool, ok, rid, k, l, s, beg, end, ovf1, bad1, n_pool, n_u,
         fqc, fcc, bq1, bc1, memo) = fns["r1"](sd.dfi, qd, rd)
        assert not np.asarray(ovf1).any(), mode
        outs[mode] = dict(
            ok=np.asarray(ok), rid=np.asarray(rid), k=np.asarray(k),
            l=np.asarray(l), s=np.asarray(s), beg=np.asarray(beg),
            end=np.asarray(end), bq=int(bq1), bc=int(bc1))
    a = outs["chain"]
    for other in ("win", "whole"):
        b = outs[other]
        assert np.array_equal(a["ok"], b["ok"]), other
        m = a["ok"]
        for f in ("rid", "k", "l", "s", "beg", "end"):
            assert np.array_equal(a[f][m], b[f][m]), (other, f)
        assert a["bq"] == b["bq"], other
    assert a["bc"] < a["bq"]


def test_adaptive_cap_doubling(tiny_fm):
    """A pool/buffer cap overflow DOUBLES the corresponding factor and
    clears the compiled programs (adaptive static shapes) instead of
    disabling the dedup path; rep-cap style disables only fire once
    the raise budget is exhausted."""
    sd = DeviceSeeder(MemOptions(), tiny_fm, dedup=True)
    gp0, t20 = sd.GP_F, sd.T2L_F
    sd._jits["sentinel"] = object()
    flags = np.zeros(11, np.int64)
    flags[0] = 1          # r1 pool
    flags[4] = 1          # r2 task lanes
    sd._note_fwd_overflow(flags)
    assert sd.GP_F == 2 * gp0 and sd.T2L_F == 2 * t20
    assert not sd.fwd_disabled            # raise, not disable
    assert "sentinel" not in sd._jits     # recompile forced
    # exhaust the raise budget -> the disable path takes over
    sd._cap_raises = 99
    flags2 = np.zeros(11, np.int64)
    flags2[2] = 1
    sd._note_fwd_overflow(flags2)
    assert sd.fwd_disabled


def test_seeder2_densified_sa(tiny_fm):
    """The full device seeder over a densify_sa(intv 8) index (the
    --sa-intv CLI lever) must produce identical matches/seeds — SAL
    depth is the only thing that changes."""
    from compseed.ops.device_index import densify_sa, to_device

    opt = MemOptions()
    queries = _fixture_queries(16)
    dfi8 = densify_sa(to_device(tiny_fm), 8)
    assert dfi8.sa_intv == 8
    sd = DeviceSeeder(opt, tiny_fm, dfi=dfi8, dedup=True)
    got = sd(tiny_fm, opt, queries)
    assert not sd.last_overflow
    for r, q in enumerate(queries):
        want = seeding.collect_matches(tiny_fm, opt, q)
        assert got[r][0] == want, f"read {r}"
    want_seeds = [seeding.sample_seeds(opt, seeding.collect_matches(
        tiny_fm, opt, q)) for q in queries]
    seeding.resolve_sal(tiny_fm, want_seeds)
    for r in range(len(queries)):
        g = [(s.rbeg, s.qbeg, s.len) for s in got[r][1]]
        w = [(s.rbeg, s.qbeg, s.len) for s in want_seeds[r]]
        assert g == w, f"read {r} seeds differ"


def test_adaptive_caps_opt_out(tiny_fm, monkeypatch):
    """COMPSEED_ADAPTIVE_CAPS=0 selects the r4 overflow response
    (disable the dedup pass) with no cap raise — measured faster at
    whole-genome interval volumes (EVIDENCE/ab_r05_notes.md hg19)."""
    monkeypatch.setenv("COMPSEED_ADAPTIVE_CAPS", "0")
    sd = DeviceSeeder(MemOptions(), tiny_fm, dedup=True)
    gp0 = sd.GP_F
    flags = np.zeros(11, np.int64)
    flags[0] = 1
    flags[2] = 1          # fwd rep caps
    sd._note_fwd_overflow(flags)
    assert sd.GP_F == gp0                 # no raise
    assert sd.fwd_disabled                # straight to disable

"""Device batched seeding vs the host seeding oracle."""

import os

import numpy as np
import pytest

from compseed.options import MemOptions
from compseed.pipeline import seeding
from compseed.pipeline.align import encode_read
from compseed.ops.smem import BatchSeeder

from tests.conftest import FIXTURES


def _fixture_queries(n):
    from compseed.io.fastq import read_fastq_chunks
    reads = []
    for chunk in read_fastq_chunks(os.path.join(FIXTURES, "reads.fq"),
                                   10_000_000):
        reads.extend(chunk)
    return [encode_read(r.seq) for r in reads[:n]]


def test_seeder_matches_oracle(tiny_fm):
    opt = MemOptions()
    queries = _fixture_queries(64)
    seeder = BatchSeeder(opt, tiny_fm)
    got = seeder(tiny_fm, opt, queries)
    for r, q in enumerate(queries):
        want_matches = seeding.collect_matches(tiny_fm, opt, q)
        got_matches, got_seeds = got[r]
        assert got_matches == want_matches, \
            f"read {r}: {got_matches} != {want_matches}"
    # seeds incl. resolved SA positions
    want_seeds = [seeding.sample_seeds(opt, seeding.collect_matches(
        tiny_fm, opt, q)) for q in queries]
    seeding.resolve_sal(tiny_fm, want_seeds)
    for r in range(len(queries)):
        g = [(s.rbeg, s.qbeg, s.len, s.score) for s in got[r][1]]
        w = [(s.rbeg, s.qbeg, s.len, s.score) for s in want_seeds[r]]
        assert g == w, f"read {r} seeds differ"


def test_seeder_with_ns_and_lengths(tiny_fm):
    """Reads with Ns, odd lengths, all-N, and short reads."""
    opt = MemOptions()
    rng = np.random.default_rng(41)
    base_qs = _fixture_queries(8)
    queries = []
    for q in base_qs:
        q = q.copy()
        for _ in range(3):
            q[int(rng.integers(0, len(q)))] = 4
        queries.append(q)
    queries.append(np.full(50, 4, dtype=np.uint8))        # all N
    queries.append(base_qs[0][:37].copy())                 # short odd length
    queries.append(base_qs[1][:19].copy())                 # == min_seed_len
    seeder = BatchSeeder(opt, tiny_fm)
    got = seeder(tiny_fm, opt, queries)
    for r, q in enumerate(queries):
        want = seeding.collect_matches(tiny_fm, opt, q)
        assert got[r][0] == want, f"read {r}"

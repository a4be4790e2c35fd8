"""Library API: SMEM iterator + single-read alignment entry."""

import numpy as np

from compseed.api import SmemIterator, align1
from compseed.cpu import fm_oracle as fo
from compseed.options import MemOptions
from compseed.pipeline.align import encode_read

from tests.test_ops_smem import _fixture_queries


def test_smem_iterator_matches_collect(tiny_fm):
    """With min_intv=1/max_intv=0 the iterator must reproduce the round-1
    pivot walk of collect_mem (same SMEM sets, same pivot sequence)."""
    queries = _fixture_queries(12)
    it = SmemIterator(tiny_fm)
    for q in queries:
        it.set_query(q)
        got = []
        for batch in it:
            got.extend((m.k, m.l, m.s, m.qbeg, m.qend) for m in batch)
        want = []
        j = 0
        while j < len(q):
            mems, j = fo.collect_mem(tiny_fm, q, j, 1)
            want.extend(mems)
        assert got == want


def test_smem_iterator_max_intv(tiny_fm):
    """max_intv > 0 terminates forward extension early (bwt.c:305-308)."""
    q = _fixture_queries(1)[0]
    it = SmemIterator(tiny_fm)
    it.config(min_intv=1, max_intv=20)
    it.set_query(q)
    batches = list(it)
    assert batches and all(len(b) >= 1 for b in batches)
    mems, _ = fo.smem1a(tiny_fm, q, 0, 1, 20)
    assert [(m.k, m.l, m.s, m.qbeg, m.qend) for m in batches[0]] == mems


def test_align1(tiny_fm):
    from tests.conftest import FIXTURES
    import os
    gold = [l for l in open(os.path.join(FIXTURES, "golden_bwamem.sam"))
            if not l.startswith("@")]
    from compseed.io.fastq import read_fastq_chunks
    reads = []
    for chunk in read_fastq_chunks(os.path.join(FIXTURES, "reads.fq"),
                                   10_000_000):
        reads.extend(chunk)
    opt = MemOptions()
    sam = align1(opt, tiny_fm, reads[0].seq, name=reads[0].name,
                 qual=reads[0].qual)
    # identical except mapq tie-break hash (mem_align1 uses lrand48 ids);
    # with id 0 it matches the batch pipeline's first record exactly
    assert sam == gold[0]

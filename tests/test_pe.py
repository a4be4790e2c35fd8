"""Paired-end pipeline vs the BWA-MEM 0.7.17 PE golden.

Exercises insert-size inference (mem_pestat), mate rescue (mem_matesw via
the exact ksw_align2 contract), pair scoring (mem_pair) and PE SAM
emission (mem_sam_pe) in the native tail — byte-identical output.
"""

import os

import pytest

from compseed.options import MemOptions, MEM_F_PE
from compseed.io.fastq import read_fastq_pair_chunks
from compseed.pipeline.align import align_chunk

from tests.conftest import FIXTURES


@pytest.mark.slow
def test_pe_golden_parity(tiny_fm):
    from compseed.native import NativeTail

    opt = MemOptions()
    opt.flag |= MEM_F_PE
    reads = []
    for chunk in read_fastq_pair_chunks(
            os.path.join(FIXTURES, "reads_1.fq"),
            os.path.join(FIXTURES, "reads_2.fq"), 10_000_000):
        reads.extend(chunk)
    tail = NativeTail(opt, tiny_fm)
    align_chunk(opt, tiny_fm, reads, 0, tail=tail)
    mine = "".join(r.sam for r in reads).splitlines(keepends=True)
    golden = [l for l in
              open(os.path.join(FIXTURES, "golden_bwamem_pe.sam"))
              if not l.startswith("@")]
    assert len(mine) == len(golden)
    for i, (m, g) in enumerate(zip(mine, golden)):
        assert m == g, f"record {i}:\n{m}\n{g}"


@pytest.mark.slow
def test_smartpe_golden_parity(tiny_fm):
    """-p interleaved/mixed input: bseq_classify splits SE vs PE groups
    (bwalib/bwa.c:113-129, fastmap.c:107-127); byte-identical to
    ``bwamem -p`` on the mixed fixture."""
    from compseed.native import NativeTail
    from compseed.io.fastq import read_fastq_chunks
    from compseed.options import MEM_F_SMARTPE
    from compseed.pipeline.align import align_chunk_smart

    opt = MemOptions()
    opt.flag |= MEM_F_PE | MEM_F_SMARTPE
    tail = NativeTail(opt, tiny_fm)
    sams = []
    n_processed = 0
    for chunk in read_fastq_chunks(
            os.path.join(FIXTURES, "reads_mixed.fq"), 10_000_000):
        align_chunk_smart(opt, tiny_fm, chunk, n_processed, tail=tail,
                          verbose=0)
        n_processed += len(chunk)
        sams.extend(r.sam for r in chunk)
    mine = "".join(sams).splitlines(keepends=True)
    golden = [l for l in
              open(os.path.join(FIXTURES, "golden_bwamem_smartpe.sam"))
              if not l.startswith("@")]
    assert len(mine) == len(golden)
    for i, (m, g) in enumerate(zip(mine, golden)):
        assert m == g, f"record {i}:\n{m}\n{g}"


def test_bseq_classify():
    """Adjacent same-name reads pair; orphans stay single."""
    from compseed.io.fastq import Read
    from compseed.pipeline.align import bseq_classify

    def mk(name):
        return Read(name=name, seq="A", qual=None, comment=None)

    reads = [mk("s0"), mk("p0"), mk("p0"), mk("s1"), mk("p1"), mk("p1"),
             mk("s2")]
    se, pe = bseq_classify(reads)
    assert [r.name for r in se] == ["s0", "s1", "s2"]
    assert [r.name for r in pe] == ["p0", "p0", "p1", "p1"]
    # a name collision NOT at an adjacent position does not pair
    se, pe = bseq_classify([mk("a"), mk("b"), mk("a")])
    assert [r.name for r in se] == ["a", "b", "a"] and pe == []
    # pair at the very front and a trailing orphan
    se, pe = bseq_classify([mk("x"), mk("x"), mk("y")])
    assert [r.name for r in pe] == ["x", "x"]
    assert [r.name for r in se] == ["y"]


def test_pe_insert_override(tiny_fm):
    """-I style pes override path produces records for every read."""
    from compseed.native import NativeTail

    opt = MemOptions()
    opt.flag |= MEM_F_PE
    reads = []
    for chunk in read_fastq_pair_chunks(
            os.path.join(FIXTURES, "reads_1.fq"),
            os.path.join(FIXTURES, "reads_2.fq"), 10_000_000):
        reads.extend(chunk)
    reads = reads[:64]
    tail = NativeTail(opt, tiny_fm)
    pes = []
    for d in range(4):
        if d == 1:
            pes += [0.0, 200.0, 500.0, 350.0, 35.0]
        else:
            pes += [1.0, 0.0, 0.0, 0.0, 0.0]
    align_chunk(opt, tiny_fm, reads, 0, tail=tail, pes_override=pes)
    assert all(r.sam for r in reads)
    flags = [int(r.sam.split("\t")[1]) for r in reads]
    assert all(f & 0x1 for f in flags)          # all paired
    assert any(f & 0x2 for f in flags)          # some proper pairs

"""ALT-contig handling vs BWA-MEM 0.7.17 goldens.

The tiny_alt fixture has ``pchr_alt`` (a 0.5%-diverged copy of a primary
slice) marked ALT via the ``.alt`` file.  Exercises bns_restore's .alt
parsing (FM_index/bntseq.c:178-209), is_alt mapq/XA/XR behavior
(comp_seed.cpp:1034-1076 mem_gen_alt), ALT supplementary records
(bwamem_pair.c / mem_reg2sam ALT branches) and -j (fastmap.c:210,387).
"""

import os

import pytest

from compseed.index.fmindex import FMIndex
from compseed.io.fastq import read_fastq_chunks, read_fastq_pair_chunks
from compseed.options import MemOptions, MEM_F_PE
from compseed.pipeline.align import align_chunk

from tests.conftest import FIXTURES


@pytest.fixture(scope="module")
def alt_fm() -> FMIndex:
    return FMIndex.load(os.path.join(FIXTURES, "tiny_alt"))


def _golden(name: str) -> list[str]:
    return [l for l in open(os.path.join(FIXTURES, name))
            if not l.startswith("@")]


def _run_se(fm, opt) -> list[str]:
    from compseed.native import NativeTail

    reads = []
    for chunk in read_fastq_chunks(
            os.path.join(FIXTURES, "reads_alt.fq"), 10_000_000):
        reads.extend(chunk)
    tail = NativeTail(opt, fm)
    align_chunk(opt, fm, reads, 0, tail=tail)
    return "".join(r.sam for r in reads).splitlines(keepends=True)


def test_alt_loaded(alt_fm):
    flags = {a.name: a.is_alt for a in alt_fm.bns.anns}
    assert flags == {"pchr": 0, "pchr_alt": 1}


def test_alt_se_golden(alt_fm):
    mine = _run_se(alt_fm, MemOptions())
    golden = _golden("golden_alt_se.sam")
    assert len(mine) == len(golden)
    for i, (m, g) in enumerate(zip(mine, golden)):
        assert m == g, f"record {i}:\n{m}\n{g}"
    # the fixture must actually exercise the ALT paths
    assert any("XR:" in l or "\tpchr_alt\t" in l for l in mine)
    assert any(int(l.split("\t")[1]) & 0x800 for l in mine)  # supplementary


def test_alt_ignore_j(alt_fm):
    """-j clears is_alt before alignment (fastmap.c:387-390)."""
    fm = FMIndex.load(os.path.join(FIXTURES, "tiny_alt"))
    for a in fm.bns.anns:
        a.is_alt = 0
    mine = _run_se(fm, MemOptions())
    golden = _golden("golden_alt_j.sam")
    assert len(mine) == len(golden)
    for i, (m, g) in enumerate(zip(mine, golden)):
        assert m == g, f"record {i}:\n{m}\n{g}"


@pytest.mark.slow
def test_alt_pe_golden(alt_fm):
    from compseed.native import NativeTail

    opt = MemOptions()
    opt.flag |= MEM_F_PE
    reads = []
    for chunk in read_fastq_pair_chunks(
            os.path.join(FIXTURES, "reads_alt_1.fq"),
            os.path.join(FIXTURES, "reads_alt_2.fq"), 10_000_000):
        reads.extend(chunk)
    tail = NativeTail(opt, alt_fm)
    align_chunk(opt, alt_fm, reads, 0, tail=tail)
    mine = "".join(r.sam for r in reads).splitlines(keepends=True)
    golden = _golden("golden_alt_pe.sam")
    assert len(mine) == len(golden)
    for i, (m, g) in enumerate(zip(mine, golden)):
        assert m == g, f"record {i}:\n{m}\n{g}"

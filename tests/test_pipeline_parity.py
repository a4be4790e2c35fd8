"""End-to-end SAM parity vs the reference BWA-MEM 0.7.17 golden output.

This is the reference's own correctness methodology (README.md:52-62): the
bwamem binary is the oracle; output must be byte-identical (modulo @PG).
"""

import os

import pytest

from compseed.io.fastq import read_fastq_chunks, read_reordered_chunks
from compseed.options import MemOptions
from compseed.pipeline.align import align_chunk
from compseed.io.sam import sam_header

from tests.conftest import FIXTURES


def _golden(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return [l for l in f if not l.startswith("@")]


def _golden_header(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return [l for l in f if l.startswith("@")]


def _load_reads(name, reader):
    reads = []
    for chunk in reader(os.path.join(FIXTURES, name), 10_000_000):
        reads.extend(chunk)
    return reads


def test_sam_parity_subset(tiny_fm):
    """First 300 reads, exercised on every test run."""
    opt = MemOptions()
    reads = _load_reads("reads.fq", read_fastq_chunks)[:300]
    align_chunk(opt, tiny_fm, reads, 0)
    mine = "".join(r.sam for r in reads).splitlines(keepends=True)
    golden = _golden("golden_bwamem.sam")
    for i, (m, g) in enumerate(zip(mine, golden)):
        assert m == g, f"record {i} differs:\nMINE: {m}\nGOLD: {g}"


def test_tail_thread_count_determinism(tiny_fm):
    """-t only changes the host tail's kt_for fan-out
    (cstl/kthread.c:51-63); SAM must be byte-identical for any count."""
    from compseed.native import NativeTail, set_threads

    reads0 = _load_reads("reads.fq", read_fastq_chunks)[:200]
    sams = []
    for nt in (1, 4):
        opt = MemOptions()
        reads = [r.__class__(**r.__dict__) for r in reads0]
        set_threads(nt)
        try:
            align_chunk(opt, tiny_fm, reads, 0,
                        tail=NativeTail(opt, tiny_fm))
        finally:
            set_threads(1)
        sams.append("".join(r.sam for r in reads))
    assert sams[0] == sams[1]


@pytest.mark.slow
def test_sam_parity_full(tiny_fm):
    opt = MemOptions()
    reads = _load_reads("reads.fq", read_fastq_chunks)
    align_chunk(opt, tiny_fm, reads, 0)
    mine = "".join(r.sam for r in reads).splitlines(keepends=True)
    golden = _golden("golden_bwamem.sam")
    assert len(mine) == len(golden)
    for i, (m, g) in enumerate(zip(mine, golden)):
        assert m == g, f"record {i} differs:\nMINE: {m}\nGOLD: {g}"


@pytest.mark.slow
def test_sam_parity_reordered(tiny_fm):
    """Compressor-reordered raw input (integer read names, no quals)."""
    opt = MemOptions()
    reads = _load_reads("reads.reordered", read_reordered_chunks)
    align_chunk(opt, tiny_fm, reads, 0)
    mine = "".join(r.sam for r in reads).splitlines(keepends=True)
    golden = _golden("golden_compseed_reordered.sam")
    assert len(mine) == len(golden)
    for i, (m, g) in enumerate(zip(mine, golden)):
        assert m == g, f"record {i} differs:\nMINE: {m}\nGOLD: {g}"


def test_sam_header(tiny_fm):
    hdr = sam_header(tiny_fm).splitlines(keepends=True)
    assert hdr == _golden_header("golden_bwamem.sam")


@pytest.mark.slow
def test_chunk_size_determinism(tiny_fm):
    """-K reproducibility contract (main.cpp:183,266): SE results must
    not depend on how the input is chunked."""
    import numpy as np
    from compseed.io.fastq import read_fastq_chunks
    from compseed.native import NativeTail
    from compseed.ops.engine import device_engine, device_seeder
    from compseed.pipeline.align import align_chunk
    from tests.conftest import FIXTURES
    import os

    opt = MemOptions()
    reads_all = []
    for chunk in read_fastq_chunks(os.path.join(FIXTURES, "reads.fq"),
                                   10_000_000):
        reads_all.extend(chunk)
    reads_all = reads_all[:300]

    def run(chunk_len):
        import copy
        rs = copy.deepcopy(reads_all)
        seeder = device_seeder(opt, tiny_fm)
        engine = device_engine(opt, tiny_fm, dfi=seeder.dfi)
        tail = NativeTail(opt, tiny_fm)
        for s in range(0, len(rs), chunk_len):
            align_chunk(opt, tiny_fm, rs[s:s + chunk_len], s,
                        engine=engine, seeder=seeder, tail=tail)
        return [r.sam for r in rs]

    a = run(300)
    b = run(128)
    assert a == b


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_align_stream_depth_parity(tiny_fm, depth, monkeypatch):
    """The overlapped chunk pipeline (align_stream) must produce the
    same SAM at any pipeline depth (COMPSEED_PIPE_DEPTH): depth only
    changes device-queue scheduling, never results or on_done order."""
    from compseed.native import NativeTail
    from compseed.ops.engine import device_engine, device_seeder
    from compseed.pipeline.align import align_chunk, align_stream
    from compseed.pipeline.seeding import SeedingStats

    monkeypatch.setenv("COMPSEED_PIPE_DEPTH", str(depth))
    opt = MemOptions()
    reads = _load_reads("reads.fq", read_fastq_chunks)[:320]
    seeder = device_seeder(opt, tiny_fm, dedup=True)
    engine = device_engine(opt, tiny_fm, dfi=seeder.dfi)
    tail = NativeTail(opt, tiny_fm)
    chunks = [[r.__class__(**r.__dict__) for r in reads[s: s + 80]]
              for s in range(0, 320, 80)]
    done = []
    st = SeedingStats()
    n = align_stream(opt, tiny_fm, iter(chunks), engine, seeder, tail,
                     on_done=done.extend, stats=st)
    assert n == 320 and len(done) == 320
    assert [r.name for r in done] == [r.name for r in reads]
    assert st.bwt_queries > 0 and st.rounds.get("npool", 0) > 0

    want = [r.__class__(**r.__dict__) for r in reads]
    for s in range(0, 320, 80):
        align_chunk(opt, tiny_fm, want[s: s + 80], s, engine=engine,
                    seeder=seeder, tail=tail)
    assert "".join(r.sam for r in done) == "".join(r.sam for r in want)

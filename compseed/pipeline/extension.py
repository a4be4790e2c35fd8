"""Cross-read batched seed extension.

The CompSeed architecture (mem_chain2aln_across_reads_V2,
mapping/comp_seed.cpp:1319-2240): every kept seed of every read in the
batch is extended *optimistically* (removing the sequential dependency on
previously-extended seeds), and a final purge pass re-applies BWA-MEM's
"seed contained in an existing alignment" skip logic in the original order,
discarding alignments whose seeds BWA-MEM would never have extended.  The
result is bit-identical to the sequential mem_chain2aln
(mapping/comp_seed.cpp:425-578) while exposing thousands of independent
banded-SW problems per batch — exactly what the device DP kernel wants.

The DP engine is pluggable: ``engine(pairs, w, pen_clip)`` receives a list
of SeqPair and returns per-pair (score, qle, tle, gtle, gscore, max_off)
with ksw_extend2 semantics (bwalib/ksw.c:380-479).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from compseed.cpu import ksw
from compseed.index.fmindex import FMIndex
from compseed.options import MemOptions
from compseed.pipeline.types import AlnReg, Chain

MAX_BAND_TRY = 2
H0_SENTINEL = -99  # H0_ (mapping/macro.h:44)


@dataclass
class SeqPair:
    """One extension problem (SeqPair, mapping/bandedSWA.h:90-99)."""
    qs: np.ndarray   # query segment (reversed for left extensions)
    rs: np.ndarray   # reference segment (reversed for left extensions)
    h0: int
    seqid: int       # read index in batch
    regid: int       # alnreg index within the read


def cal_max_gap(opt: MemOptions, qlen: int) -> int:
    """comp_seed.cpp:415-421."""
    l_del = int((qlen * opt.a - opt.o_del) / opt.e_del + 1.0)
    l_ins = int((qlen * opt.a - opt.o_ins) / opt.e_ins + 1.0)
    l = max(max(l_del, l_ins), 1)
    return min(l, opt.w * 2)


def oracle_engine(opt: MemOptions):
    """Per-pair scalar DP engine (the parity oracle)."""
    mat = np.array(opt.mat)

    def run(pairs: list[SeqPair], w: int, pen_clip: int):
        out = []
        for sp in pairs:
            out.append(ksw.extend(len(sp.qs), sp.qs, len(sp.rs), sp.rs, mat,
                                  opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                                  w, pen_clip, opt.zdrop, sp.h0))
        return out
    return run


def extend_batch(opt: MemOptions, fm: FMIndex, reads: list[np.ndarray],
                 chains_per_read: list[list[Chain]], engine
                 ) -> list[list[AlnReg]]:
    """Extend all kept seeds of a batch; returns per-read alnreg lists with
    purged entries carrying qb == qe == -1 (excluded by the caller)."""
    l_pac = fm.l_pac
    regs_per_read: list[list[AlnReg]] = [[] for _ in reads]
    left_pairs: list[SeqPair] = []
    right_pairs: list[SeqPair] = []
    srt_per_chain: list[list[list[int]]] = []  # [read][chain] -> seed order

    # ---- pass 1: emit SeqPairs (comp_seed.cpp:1358-1684)
    for l, query in enumerate(reads):
        l_query = len(query)
        av = regs_per_read[l]
        srt_chains: list[list[int]] = []
        srt_per_chain.append(srt_chains)
        for c in chains_per_read[l]:
            if c.n == 0:
                srt_chains.append([])
                continue
            # max possible span (comp_seed.cpp:1394-1416)
            rmax0, rmax1 = l_pac << 1, 0
            for t in c.seeds:
                b = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
                e = t.rbeg + t.len + ((l_query - t.qbeg - t.len) +
                                      cal_max_gap(opt, l_query - t.qbeg - t.len))
                rmax0 = min(rmax0, b)
                rmax1 = max(rmax1, e)
            rmax0 = max(rmax0, 0)
            rmax1 = min(rmax1, l_pac << 1)
            if rmax0 < l_pac < rmax1:
                if c.seeds[0].rbeg < l_pac:
                    rmax1 = l_pac
                else:
                    rmax0 = l_pac
            rseq, rid, rmax0, rmax1 = fm.fetch_seq(rmax0, c.seeds[0].rbeg, rmax1)
            assert rid == c.rid

            # seeds by ascending (score, index); keys are unique
            srt = sorted(range(c.n),
                         key=lambda i: (c.seeds[i].score << 32) | i)
            srt_chains.append(srt)

            for k in range(c.n - 1, -1, -1):
                s = c.seeds[srt[k]]
                a = AlnReg(w=opt.w, score=-1, truesc=-1, rid=c.rid,
                           frac_rep=c.frac_rep, seedlen0=s.len, chain=c,
                           rb=H0_SENTINEL, qb=H0_SENTINEL,
                           re=H0_SENTINEL, qe=H0_SENTINEL)
                av.append(a)
                s.aln = len(av) - 1

                if s.qbeg:  # left extension pending
                    qs = query[s.qbeg - 1::-1].copy()
                    tmp = s.rbeg - rmax0
                    rs = rseq[tmp - 1::-1].copy() if tmp > 0 else rseq[:0]
                    left_pairs.append(SeqPair(qs=qs, rs=rs,
                                              h0=s.len * opt.a,
                                              seqid=l, regid=s.aln))
                    a.qb, a.rb = s.qbeg, s.rbeg
                else:
                    a.score = a.truesc = s.len * opt.a
                    a.qb, a.rb = 0, s.rbeg

                if s.qbeg + s.len != l_query:  # right extension pending
                    qe = s.qbeg + s.len
                    re = s.rbeg + s.len - rmax0
                    assert re >= 0
                    right_pairs.append(SeqPair(
                        qs=query[qe:].copy(), rs=rseq[re:].copy(),
                        h0=H0_SENTINEL, seqid=l, regid=s.aln))
                    a.qe, a.re = qe, rmax0 + re
                else:
                    a.qe, a.re = l_query, s.rbeg + s.len
                    if a.rb != H0_SENTINEL and a.qb != H0_SENTINEL:
                        _seedcov(a)

    # ---- left extensions with band-doubling retry (comp_seed.cpp:1713-1911)
    pairs = left_pairs
    for i in range(MAX_BAND_TRY):
        w = opt.w << i
        results = engine(pairs, w, opt.pen_clip5)
        requeue = []
        for sp, (score, qle, tle, gtle, gscore, max_off) in zip(pairs, results):
            a = regs_per_read[sp.seqid][sp.regid]
            prev = a.score
            a.score = score
            if a.score == prev or max_off < (w >> 1) + (w >> 2) or \
                    i + 1 == MAX_BAND_TRY:
                if gscore <= 0 or gscore <= a.score - opt.pen_clip5:
                    a.qb -= qle
                    a.rb -= tle
                    a.truesc = a.score
                else:
                    a.qb = 0
                    a.rb -= gtle
                    a.truesc = gscore
                a.w = max(a.w, w)
                if H0_SENTINEL not in (a.rb, a.qb, a.qe, a.re):
                    _seedcov(a)
            else:
                requeue.append(sp)
        pairs = requeue

    # ---- right extensions seeded with the left score (comp_seed.cpp:1918-2126)
    for sp in right_pairs:
        sp.h0 = regs_per_read[sp.seqid][sp.regid].score
    pairs = right_pairs
    for i in range(MAX_BAND_TRY):
        w = opt.w << i
        results = engine(pairs, w, opt.pen_clip3)
        requeue = []
        for sp, (score, qle, tle, gtle, gscore, max_off) in zip(pairs, results):
            a = regs_per_read[sp.seqid][sp.regid]
            prev = a.score
            a.score = score
            if a.score == prev or max_off < (w >> 1) + (w >> 2) or \
                    i + 1 == MAX_BAND_TRY:
                if gscore <= 0 or gscore <= a.score - opt.pen_clip3:
                    a.qe += qle
                    a.re += tle
                    a.truesc += a.score - sp.h0
                else:
                    a.qe = len(reads[sp.seqid])
                    a.re += gtle
                    a.truesc += gscore - sp.h0
                a.w = max(a.w, w)
                if H0_SENTINEL not in (a.rb, a.qb, a.qe, a.re):
                    _seedcov(a)
            else:
                requeue.append(sp)
        pairs = requeue

    # ---- purge pass (comp_seed.cpp:2141-2235): re-apply BWA-MEM's
    # contained-seed skip logic in the original processing order
    for l, query in enumerate(reads):
        l_query = len(query)
        av = regs_per_read[l]
        kept: list[int] = []  # alnreg indices of kept seeds, creation order
        for j, c in enumerate(chains_per_read[l]):
            srt = srt_per_chain[l][j]
            purged = [False] * c.n
            for k in range(c.n - 1, -1, -1):
                s = c.seeds[srt[k]]
                contained = False
                for idx in kept:
                    p = av[idx]
                    if (s.rbeg < p.rb or s.rbeg + s.len > p.re or
                            s.qbeg < p.qb or s.qbeg + s.len > p.qe):
                        continue  # not fully contained
                    if s.len - p.seedlen0 > 0.1 * l_query:
                        continue
                    qd = s.qbeg - p.qb
                    rd = s.rbeg - p.rb
                    w = min(cal_max_gap(opt, min(qd, rd)), p.w)
                    if qd - rd < w and rd - qd < w:
                        contained = True
                        break
                    qd = p.qe - (s.qbeg + s.len)
                    rd = p.re - (s.rbeg + s.len)
                    w = min(cal_max_gap(opt, min(qd, rd)), p.w)
                    if qd - rd < w and rd - qd < w:
                        contained = True
                        break
                if contained:
                    overlap = False
                    for v in range(k + 1, c.n):
                        if purged[v]:
                            continue
                        t = c.seeds[srt[v]]
                        if t.len < s.len * 0.95:
                            continue
                        if (s.qbeg <= t.qbeg and
                                s.qbeg + s.len - t.qbeg >= s.len >> 2 and
                                t.qbeg - s.qbeg != t.rbeg - s.rbeg):
                            overlap = True
                            break
                        if (t.qbeg <= s.qbeg and
                                t.qbeg + t.len - s.qbeg >= s.len >> 2 and
                                s.qbeg - t.qbeg != s.rbeg - t.rbeg):
                            overlap = True
                            break
                    if not overlap:  # skip: purge this alignment
                        av[s.aln].qb = av[s.aln].qe = -1
                        purged[k] = True
                        continue
                kept.append(s.aln)
    return regs_per_read


def _seedcov(a: AlnReg) -> None:
    """Seed coverage of the alignment region (comp_seed.cpp:1756-1761)."""
    cov = 0
    for t in a.chain.seeds:
        if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe and
                t.rbeg >= a.rb and t.rbeg + t.len <= a.re):
            cov += t.len
    a.seedcov = cov

"""Seed chaining and chain filtering.

Contracts: test_and_merge / mem_chain / mem_chain_weight / mem_chain_flt /
mem_seed_sw / mem_flt_chained_seeds (mapping/comp_seed.cpp:176-409).

The reference keeps chains in a B-tree keyed by position; we keep a sorted
list with bisect — same "closest chain at or below the seed position"
lookup (kb_intervalp, cstl/kbtree.h:152-168: exact hit returns that chain,
otherwise the largest chain below).
"""

from __future__ import annotations

import bisect
import math

import numpy as np

from compseed.cpu import ksw
from compseed.cpu.sort import ks_introsort
from compseed.index.fmindex import FMIndex
from compseed.options import MemOptions
from compseed.pipeline.types import Chain, Seed

MEM_SHORT_EXT = 50
MEM_SHORT_LEN = 200
MEM_HSP_COEF = 1.1
MEM_MINSC_COEF = 5.5
MEM_SEEDSW_COEF = 0.05


def _test_and_merge(opt: MemOptions, l_pac: int, c: Chain, p: Seed,
                    seed_rid: int) -> bool:
    """comp_seed.cpp:182-203; True if seed is contained in or merged into c."""
    last = c.seeds[-1]
    qend = last.qbeg + last.len
    rend = last.rbeg + last.len
    if seed_rid != c.rid:
        return False
    if (p.qbeg >= c.seeds[0].qbeg and p.qbeg + p.len <= qend and
            p.rbeg >= c.seeds[0].rbeg and p.rbeg + p.len <= rend):
        return True  # contained seed
    if (last.rbeg < l_pac or c.seeds[0].rbeg < l_pac) and p.rbeg >= l_pac:
        return False  # different strands
    x = p.qbeg - last.qbeg
    y = p.rbeg - last.rbeg
    if (y >= 0 and x - y <= opt.w and y - x <= opt.w and
            x - last.len < opt.max_chain_gap and
            y - last.len < opt.max_chain_gap):
        c.seeds.append(p)
        return True
    return False


def chain_weight(c: Chain) -> int:
    """Non-overlapping seed cover, min over query/ref (comp_seed.cpp:205-223)."""
    w = 0
    end = 0
    for s in c.seeds:
        if s.qbeg >= end:
            w += s.len
        elif s.qbeg + s.len > end:
            w += s.qbeg + s.len - end
        end = max(end, s.qbeg + s.len)
    tmp = w
    w = 0
    end = 0
    for s in c.seeds:
        if s.rbeg >= end:
            w += s.len
        elif s.rbeg + s.len > end:
            w += s.rbeg + s.len - end
        end = max(end, s.rbeg + s.len)
    w = min(w, tmp)
    return min(w, (1 << 30) - 1)


def l_rep_one(rows, max_occ: int) -> int:
    """Length of the read covered by over-occurring matches — the only
    quantity chaining derives from the match list (comp_seed.cpp:271-281:
    interval union over occ > max_occ matches, which arrive sorted by
    (beg, end)).  ``rows`` yields (beg, end, occ) tuples."""
    beg = end = l_rep = 0
    for mbeg, mend, occ in rows:
        if occ <= max_occ:
            continue
        if mbeg > end:
            l_rep += end - beg
            beg, end = mbeg, mend
        else:
            end = max(end, mend)
    return l_rep + (end - beg)


def l_rep_flat(mflat: np.ndarray, moff: np.ndarray,
               max_occ: int) -> np.ndarray:
    """Per-read l_rep from a flat (beg, end, occ) match matrix."""
    n = len(moff) - 1
    out = np.zeros(n, np.int64)
    for r in range(n):
        out[r] = l_rep_one(mflat[moff[r]:moff[r + 1]], max_occ)
    return out


def mem_chain(opt: MemOptions, fm: FMIndex, l_query: int,
              matches: list[tuple], seeds: list[Seed]) -> list[Chain]:
    """comp_seed.cpp:241-285."""
    if l_query < opt.min_seed_len:
        return []
    chains: list[Chain] = []   # kept sorted by pos
    positions: list[int] = []
    for s in seeds:
        rid = fm.intv2rid(s.rbeg, s.rbeg + s.len)
        if rid < 0:
            continue  # bridging contigs or the strand boundary
        to_add = not chains
        if chains:
            i = bisect.bisect_right(positions, s.rbeg) - 1
            lower = chains[i] if i >= 0 else None
            if lower is None or not _test_and_merge(opt, fm.l_pac, lower, s, rid):
                to_add = True
        if to_add:
            c = Chain(pos=s.rbeg, rid=rid,
                      is_alt=1 if fm.bns.anns[rid].is_alt else 0,
                      seeds=[s])
            j = bisect.bisect_right(positions, s.rbeg)
            positions.insert(j, s.rbeg)
            chains.insert(j, c)

    # repetition fraction from over-occurring matches (comp_seed.cpp:271-281)
    l_rep = l_rep_one([(mbeg, mend, s_) for _, _, s_, mbeg, mend in matches],
                      opt.max_occ)
    # mem_chain_t.frac_rep is a C float (comp_seed.h:100); keep f32 rounding
    frac = float(np.float32(l_rep / l_query))
    for c in chains:
        c.frac_rep = frac
    return chains


def mem_chain_flt(opt: MemOptions, chains: list[Chain]) -> list[Chain]:
    """Drop light and heavily-shadowed chains (comp_seed.cpp:297-354)."""
    if not chains:
        return []
    a = []
    for c in chains:
        c.first = -1
        c.kept = 0
        c.w = chain_weight(c)
        if c.w >= opt.min_chain_weight:
            a.append(c)
    if not a:
        return []
    # ks_introsort(mem_flt) with flt_lt = (a.w > b.w): the permutation of
    # equal-weight chains feeds into alnreg order and hash tie-breaking,
    # so the exact introsort replica is required (comp_seed.cpp:310).
    ks_introsort(a, lambda x, y: x.w > y.w)
    n_chn = len(a)

    def chn_beg(c: Chain) -> int:
        return c.seeds[0].qbeg

    def chn_end(c: Chain) -> int:
        return c.seeds[-1].qbeg + c.seeds[-1].len

    kept_idx = [0]
    a[0].kept = 3
    for i in range(1, n_chn):
        large_ovlp = False
        broke = False
        for j in kept_idx:
            b_max = max(chn_beg(a[j]), chn_beg(a[i]))
            e_min = min(chn_end(a[j]), chn_end(a[i]))
            if e_min > b_max and (not a[j].is_alt or a[i].is_alt):
                li = chn_end(a[i]) - chn_beg(a[i])
                lj = chn_end(a[j]) - chn_beg(a[j])
                min_l = min(li, lj)
                if e_min - b_max >= min_l * opt.mask_level and \
                        min_l < opt.max_chain_gap:
                    large_ovlp = True
                    if a[j].first < 0:
                        a[j].first = i
                    if a[i].w < a[j].w * opt.drop_ratio and \
                            a[j].w - a[i].w >= opt.min_seed_len * 2:
                        broke = True
                        break
        if not broke:
            kept_idx.append(i)
            a[i].kept = 2 if large_ovlp else 3
    for j in kept_idx:
        if a[j].first >= 0:
            a[a[j].first].kept = 1
    # cap the number of extended shadowed chains (comp_seed.cpp:342-347)
    k = 0
    i = 0
    cut = n_chn
    for i in range(n_chn):
        if a[i].kept == 0 or a[i].kept == 3:
            continue
        k += 1
        if k >= opt.max_chain_extend:
            cut = i
            break
    for i in range(cut, n_chn):
        if a[i].kept < 3:
            a[i].kept = 0
    return [c for c in a if c.kept != 0]


def mem_seed_sw(opt: MemOptions, fm: FMIndex, l_query: int,
                query: np.ndarray, s: Seed) -> int:
    """Score one seed with +-50bp local SW (comp_seed.cpp:367-391)."""
    if s.len >= MEM_SHORT_LEN:
        return -1
    l_pac = fm.l_pac
    qb, qe = s.qbeg, s.qbeg + s.len
    rb, re = s.rbeg, s.rbeg + s.len
    mid = (rb + re) >> 1
    qb = max(qb - MEM_SHORT_EXT, 0)
    qe = min(qe + MEM_SHORT_EXT, l_query)
    rb = max(rb - MEM_SHORT_EXT, 0)
    re = min(re + MEM_SHORT_EXT, l_pac << 1)
    if rb < l_pac < re:
        if mid < l_pac:
            re = l_pac
        else:
            rb = l_pac
    if qe - qb >= MEM_SHORT_LEN or re - rb >= MEM_SHORT_LEN:
        return -1
    rseq, _, rb, re = fm.fetch_seq(rb, mid, re)
    return ksw.local_score(qe - qb, query[qb:qe], re - rb, rseq,
                           np.array(opt.mat), opt.o_del, opt.e_del,
                           opt.o_ins, opt.e_ins)


def mem_flt_chained_seeds(opt: MemOptions, fm: FMIndex, l_query: int,
                          query: np.ndarray, chains: list[Chain]) -> None:
    """comp_seed.cpp:393-409."""
    min_l = (MEM_HSP_COEF * opt.min_chain_weight) if opt.min_chain_weight \
        else MEM_MINSC_COEF * math.log(l_query)
    min_hsp_score = int(opt.a * min_l + 0.499)
    if min_l > MEM_SEEDSW_COEF * l_query:
        return
    for c in chains:
        kept = []
        for s in c.seeds:
            s.score = mem_seed_sw(opt, fm, l_query, query, s)
            if s.score < 0 or s.score >= min_hsp_score:
                s.score = s.len * opt.a if s.score < 0 else s.score
                kept.append(s)
        c.seeds = kept

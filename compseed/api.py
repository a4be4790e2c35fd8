"""Library-level alignment API.

The reference exposes a pull-style SMEM iterator and a single-read
alignment entry besides the CLI (mapping/bwamem_extra.c):

  * ``SmemIterator``  — smem_itr_init / smem_set_query / smem_config /
    smem_next (bwamem_extra.c:21-69): iterate SMEM batches across a
    query, with the min_intv / max_len / max_intv knobs.
  * ``align1``        — mem_align1 (bwamem_extra.c:75-87): align one
    sequence and return its SAM record(s); unlike the pipeline entry it
    does not need batching or a driver.

Both run against the scalar FM oracle — these are convenience/debug
entries, not the production batch path (pipeline.align / ops.seeder2).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from compseed.cpu import fm_oracle as fo
from compseed.index.fmindex import FMIndex
from compseed.options import MemOptions
from compseed.utils import NT4_TABLE


@dataclass
class Smem:
    """One super-maximal exact match: bi-interval + query span."""
    k: int
    l: int
    s: int
    qbeg: int
    qend: int


class SmemIterator:
    """Pull-style SMEM iterator (smem_i, bwamem_extra.c:10-69)."""

    def __init__(self, fm: FMIndex):
        self.fm = fm
        self.min_intv = 1
        self.max_len = 1 << 31
        self.max_intv = 0
        self._query: np.ndarray | None = None
        self._start = 0

    def set_query(self, query) -> None:
        """query: nt4 codes (np.uint8) or an ACGTN string."""
        if isinstance(query, str):
            query = NT4_TABLE[np.frombuffer(query.encode(),
                                            dtype=np.uint8)].copy()
        self._query = np.asarray(query, dtype=np.uint8)
        self._start = 0

    def config(self, min_intv: int = 1, max_len: int = 1 << 31,
               max_intv: int = 0) -> None:
        self.min_intv = min_intv
        self.max_len = max_len
        self.max_intv = max_intv

    def __iter__(self):
        return self

    def __next__(self) -> list[Smem]:
        batch = self.next()
        if batch is None:
            raise StopIteration
        return batch

    def next(self) -> list[Smem] | None:
        """SMEMs covering the next pivot, or None at the end."""
        q = self._query
        if q is None or self._start < 0 or self._start >= len(q):
            return None
        while self._start < len(q) and q[self._start] > 3:
            self._start += 1
        if self._start == len(q):
            return None
        mems, ret = fo.smem1a(self.fm, q, self._start, self.min_intv,
                              self.max_intv)
        self._start = ret
        return [Smem(k=m[0], l=m[1], s=m[2], qbeg=m[3], qend=m[4])
                for m in mems]


def align1(opt: MemOptions, fm: FMIndex, seq: str,
           name: str = "read1", qual: str | None = None) -> str:
    """Align one sequence; returns its SAM record(s) (mem_align1,
    bwamem_extra.c:75-87, fused with the SE finalize of worker2)."""
    from compseed.io.fastq import Read
    from compseed.pipeline.align import align_batch

    read = Read(name=name, seq=seq, qual=qual, comment=None)
    align_batch(opt, fm, [read], 0)
    return read.sam

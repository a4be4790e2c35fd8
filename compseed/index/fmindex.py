"""Runtime FM-index bundle: FMD-index + reference metadata + packed reference.

Equivalent of bwaidx_t {bwt, bns, pac} (bwalib/bwa.h:48-56) plus the
coordinate-transform helpers of FM_index/bntseq.c.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from compseed.index.build import (
    OCC_INTERVAL, BntSeq, BuiltIndex, pack_bwt_words, unpack_pac,
)
from compseed.index import io as idx_io


@dataclass
class FMIndex:
    primary: int
    L2: np.ndarray            # int64[5]
    seq_len: int              # = 2 * l_pac
    bwt_words: np.ndarray     # uint32[(n_blocks, 8)] 2-bit packed BWT, padded
    cp_occ: np.ndarray        # uint64[n_blocks + 1, 4] checkpoint counts
    sa_intv: int
    sa_sampled: np.ndarray    # uint64[n_sa]
    bns: BntSeq
    pac: np.ndarray           # uint8 packed forward reference

    @property
    def l_pac(self) -> int:
        return self.bns.l_pac

    @property
    def n_blocks(self) -> int:
        return (self.seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL

    # ---------------------------------------------------------- construction
    @classmethod
    def from_built(cls, built: BuiltIndex) -> "FMIndex":
        words = pack_bwt_words(built.bwt_codes)
        return cls(
            primary=built.primary, L2=built.L2.copy(), seq_len=built.seq_len,
            bwt_words=_block_pad(words), cp_occ=built.cp_occ,
            sa_intv=built.sa_intv, sa_sampled=built.sa_sampled,
            bns=built.bns, pac=built.pac,
        )

    @classmethod
    def load(cls, prefix: str) -> "FMIndex":
        primary, L2, seq_len, words, cp_occ = idx_io.read_bwt(prefix + ".bwt")
        sa_intv, sa = idx_io.read_sa(prefix + ".sa", primary, seq_len)
        bns = idx_io.read_ann_amb(prefix)
        pac, l_pac = idx_io.read_pac(prefix + ".pac")
        if l_pac * 2 != seq_len:
            raise ValueError("pac/bwt length mismatch")
        return cls(primary=primary, L2=L2, seq_len=seq_len,
                   bwt_words=_block_pad(words), cp_occ=cp_occ,
                   sa_intv=sa_intv, sa_sampled=sa, bns=bns, pac=pac)

    def save(self, prefix: str) -> None:
        idx_io.write_bwt(prefix + ".bwt", self.primary, self.L2, self.seq_len,
                         self.bwt_words.reshape(-1)[: (self.seq_len + 15) >> 4],
                         self.cp_occ)
        idx_io.write_sa(prefix + ".sa", self.primary, self.L2, self.sa_intv,
                        self.seq_len, self.sa_sampled)
        idx_io.write_pac(prefix + ".pac", self.pac, self.l_pac)
        idx_io.write_ann_amb(prefix, self.bns)

    # ----------------------------------------------------- coordinate helpers
    def depos(self, pos: int) -> tuple[int, bool]:
        """Map forward-reverse coordinate to forward coordinate.
        Contract: bns_depos (FM_index/bntseq.h:87-90)."""
        is_rev = pos >= self.l_pac
        return ((self.l_pac << 1) - 1 - pos) if is_rev else pos, is_rev

    def pos2rid(self, pos_f: int) -> int:
        """Contract: bns_pos2rid (FM_index/bntseq.c:354-368)."""
        if pos_f >= self.l_pac:
            return -1
        offsets = self._offsets()
        return int(np.searchsorted(offsets, pos_f, side="right")) - 1

    def _offsets(self) -> np.ndarray:
        if not hasattr(self, "_off_cache"):
            self._off_cache = np.array([a.offset for a in self.bns.anns],
                                       dtype=np.int64)
        return self._off_cache

    def intv2rid(self, rb: int, re: int) -> int:
        """Contract: bns_intv2rid (FM_index/bntseq.c:370-378)."""
        if rb < self.l_pac and re > self.l_pac:
            return -2
        pos_b, _ = self.depos(rb)
        rid_b = self.pos2rid(pos_b)
        if rb < re:
            pos_e, _ = self.depos(re - 1)
            rid_e = self.pos2rid(pos_e)
        else:
            rid_e = rid_b
        return rid_b if rid_b == rid_e else -1

    def get_seq(self, beg: int, end: int) -> np.ndarray:
        """Fetch [beg, end) from the forward-reverse concatenated space.
        Contract: bns_get_seq (FM_index/bntseq.c:403-424)."""
        l_pac = self.l_pac
        if end < beg:
            beg, end = end, beg
        end = min(end, l_pac << 1)
        beg = max(beg, 0)
        if beg >= l_pac or end <= l_pac:
            if beg >= l_pac:  # reverse strand
                beg_f = (l_pac << 1) - end
                end_f = (l_pac << 1) - beg
                fwd = unpack_pac_range(self.pac, beg_f, end_f)
                return (3 - fwd)[::-1].copy()
            return unpack_pac_range(self.pac, beg, end)
        return np.zeros(0, dtype=np.uint8)  # bridges the strand boundary

    def fetch_seq(self, beg: int, mid: int, end: int) -> tuple[np.ndarray, int, int, int]:
        """Clip [beg,end) to mid's contig and fetch; returns (seq, rid, beg, end).
        Contract: bns_fetch_seq (FM_index/bntseq.c:426-451)."""
        if end < beg:
            beg, end = end, beg
        pos_m, is_rev = self.depos(mid)
        rid = self.pos2rid(pos_m)
        ann = self.bns.anns[rid]
        far_beg, far_end = ann.offset, ann.offset + ann.length
        if is_rev:
            far_beg, far_end = ((self.l_pac << 1) - far_end,
                                (self.l_pac << 1) - far_beg)
        beg = max(beg, far_beg)
        end = min(end, far_end)
        seq = self.get_seq(beg, end)
        assert len(seq) == end - beg
        return seq, rid, beg, end


def unpack_pac_range(pac: np.ndarray, beg: int, end: int) -> np.ndarray:
    """Unpack forward-strand bases [beg, end) from the 2-bit array."""
    if end <= beg:
        return np.zeros(0, dtype=np.uint8)
    b0, b1 = beg >> 2, (end + 3) >> 2
    chunk = pac[b0:b1]
    out = np.empty(len(chunk) * 4, dtype=np.uint8)
    out[0::4] = chunk >> 6
    out[1::4] = (chunk >> 4) & 3
    out[2::4] = (chunk >> 2) & 3
    out[3::4] = chunk & 3
    return out[beg - b0 * 4: beg - b0 * 4 + (end - beg)]


def _block_pad(words: np.ndarray) -> np.ndarray:
    """Reshape flat packed-BWT words to (n_blocks, 8), zero-padded."""
    n_blocks = (len(words) + 7) // 8
    out = np.zeros((n_blocks, 8), dtype=np.uint32)
    out.reshape(-1)[: len(words)] = words
    return out

"""Blocked (low-memory) BWT construction vs the in-core builder.

The blocked path (build_index_blocked / csrc/bwtinc.cpp) must produce
byte-identical artifacts to build_index — same contract as the
reference, where is_bwt (FM_index/is.c:208) and bwt_bwtgen2
(FM_index/bwt_gen.c:1598) are interchangeable producers of .bwt.
Exercises many merge rounds (tiny blocks), repeat-heavy content (the
doubling tie-break path) and N holes.
"""

import os

import numpy as np
import pytest

from compseed.index.build import (build_index, build_index_blocked,
                                      pack_pac, unpack_pac)
from compseed.utils import NT4_TO_ASCII


def _write_fa(path, parts):
    with open(path, "w") as f:
        for i, codes in enumerate(parts):
            s = bytes(NT4_TO_ASCII[codes]).decode()
            f.write(f">c{i}\n")
            for j in range(0, len(s), 70):
                f.write(s[j:j + 70] + "\n")


def _genome(tmp_path, n=60_000, seed=7, with_repeats=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    if with_repeats:
        unit = codes[100:271].copy()          # 171-mer tandem array
        tile = np.tile(unit, max(4, n // 2000))
        end = min(n - 100, n // 10 + len(tile))
        codes[n // 10:end] = tile[:end - n // 10]
        d = min(1000, n // 10)
        codes[(3 * n) // 4:(3 * n) // 4 + d] = codes[1000:1000 + d]
        codes[n // 2:n // 2 + 50] = 4               # N hole
    fa = os.path.join(tmp_path, "g.fa")
    _write_fa(fa, [codes[: n // 2], codes[n // 2:]])
    return fa


@pytest.mark.parametrize("first,block", [(1 << 14, 1 << 12),
                                         (1 << 15, 1 << 14)])
def test_blocked_equals_incore(tmp_path, first, block):
    fa = _genome(str(tmp_path))
    a = build_index(fa)
    b = build_index_blocked(fa, first_block=first, block_size=block)
    assert b.primary == a.primary
    assert b.seq_len == a.seq_len
    assert np.array_equal(b.bwt_codes, a.bwt_codes)
    assert np.array_equal(b.sa_sampled, a.sa_sampled)
    assert np.array_equal(b.cp_occ, a.cp_occ)
    assert np.array_equal(b.L2, a.L2)
    assert np.array_equal(b.pac, a.pac)


def test_blocked_single_merge_of_whole_rest(tmp_path):
    """One giant merge (block_size > text) — the degenerate schedule."""
    fa = _genome(str(tmp_path), n=20_000, seed=9)
    a = build_index(fa)
    b = build_index_blocked(fa, first_block=1 << 12, block_size=1 << 26)
    assert b.primary == a.primary
    assert np.array_equal(b.bwt_codes, a.bwt_codes)
    assert np.array_equal(b.sa_sampled, a.sa_sampled)


def test_blocked_boundary_in_tandem_repeat(tmp_path):
    """Force a block boundary inside a periodic region: the deep
    doubling tie-break case (suffixes equal for thousands of chars)."""
    rng = np.random.default_rng(11)
    n = 40_000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    unit = codes[:171].copy()
    codes[8_000:28_000] = np.tile(unit, 117)[:20_000]
    fa = os.path.join(str(tmp_path), "rep.fa")
    _write_fa(fa, [codes])
    a = build_index(fa)
    # block boundaries at 4k steps land inside the repeat many times
    b = build_index_blocked(fa, first_block=1 << 13, block_size=1 << 12)
    assert b.primary == a.primary
    assert np.array_equal(b.bwt_codes, a.bwt_codes)
    assert np.array_equal(b.sa_sampled, a.sa_sampled)


def test_pack_roundtrip():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 1001).astype(np.uint8)
    assert np.array_equal(unpack_pac(pack_pac(codes), 1001), codes)

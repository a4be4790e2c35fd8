"""Index construction & IO: byte-parity with the reference bwaidx output."""

import os

import numpy as np
import pytest

from compseed.index.build import build_index, pack_pac, unpack_pac
from compseed.index.fmindex import FMIndex, unpack_pac_range
from compseed.index.io import save_index
from compseed.index.suffix import suffix_array

from tests.conftest import FIXTURES


def test_suffix_array_brute():
    rng = np.random.default_rng(0)
    for n in [1, 2, 5, 37, 200]:
        s = rng.integers(0, 4, size=n).astype(np.uint8)
        sa = suffix_array(s)
        suf = sorted(range(n + 1), key=lambda i: bytes(s[i:]) + b"")
        # sentinel suffix (empty) sorts first
        assert sa[0] == n
        assert list(sa) == suf


def test_pac_roundtrip():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=1001).astype(np.uint8)
    pac = pack_pac(codes)
    assert np.array_equal(unpack_pac(pac, 1001), codes)
    assert np.array_equal(unpack_pac_range(pac, 17, 503), codes[17:503])


def test_index_files_byte_identical(tmp_path, tiny_built):
    """Our builder writes byte-identical .pac/.ann/.amb/.bwt/.sa to bwaidx."""
    prefix = str(tmp_path / "mine")
    save_index(prefix, tiny_built)
    for ext in [".pac", ".ann", ".amb", ".bwt", ".sa"]:
        golden = open(os.path.join(FIXTURES, "tiny" + ext), "rb").read()
        mine = open(prefix + ext, "rb").read()
        assert mine == golden, f"{ext} differs"


def test_index_load_roundtrip(tmp_path, tiny_built, tiny_fm):
    prefix = str(tmp_path / "rt")
    save_index(prefix, tiny_built)
    fm2 = FMIndex.load(prefix)
    assert fm2.primary == tiny_fm.primary
    assert fm2.seq_len == tiny_fm.seq_len
    assert np.array_equal(fm2.L2, tiny_fm.L2)
    assert np.array_equal(fm2.bwt_words, tiny_fm.bwt_words)
    assert np.array_equal(fm2.cp_occ, tiny_fm.cp_occ)
    assert np.array_equal(fm2.sa_sampled, tiny_fm.sa_sampled)
    assert fm2.bns.l_pac == tiny_fm.bns.l_pac
    assert [a.name for a in fm2.bns.anns] == [a.name for a in tiny_fm.bns.anns]
    assert len(fm2.bns.ambs) == len(tiny_fm.bns.ambs)


def test_coordinate_helpers(tiny_fm):
    fm = tiny_fm
    l_pac = fm.l_pac
    assert fm.pos2rid(0) == 0
    assert fm.pos2rid(fm.bns.anns[1].offset) == 1
    assert fm.pos2rid(l_pac) == -1
    pos, rev = fm.depos(2 * l_pac - 1)
    assert (pos, rev) == (0, True)
    # forward fetch matches pac content
    seq = fm.get_seq(100, 200)
    assert len(seq) == 100
    # reverse strand fetch is the reverse complement of the mirrored window
    rseq = fm.get_seq(2 * l_pac - 200, 2 * l_pac - 100)
    fseq = fm.get_seq(100, 200)
    assert np.array_equal(rseq, (3 - fseq)[::-1])
    # bridging returns empty
    assert len(fm.get_seq(l_pac - 10, l_pac + 10)) == 0


def test_native_sais_matches_numpy():
    """csrc/sais.cpp vs the numpy prefix-doubling builder, including
    repeat-heavy adversarial strings."""
    import numpy as np
    from compseed.index.suffix import suffix_array
    from compseed.native import suffix_array_native

    rng = np.random.default_rng(11)
    cases = [rng.integers(0, 4, n).astype(np.uint8)
             for n in (1, 7, 500, 40000)]
    cases.append(np.zeros(3000, np.uint8))
    cases.append(np.tile(np.array([2, 0, 3, 3, 1], np.uint8), 1500))
    for s in cases:
        assert np.array_equal(suffix_array_native(s),
                              suffix_array(s).astype(np.int64))

"""Shared-memory index staging (bwashm.c equivalent)."""

import numpy as np

from tests.conftest import FIXTURES
import os


def test_shm_roundtrip(tiny_fm):
    from compseed.index import shm

    name = shm.shm_stage(os.path.join(FIXTURES, "tiny"), "pytest_tiny")
    try:
        assert shm.shm_available("pytest_tiny")
        fm = shm.shm_load("pytest_tiny")
        assert fm.primary == tiny_fm.primary
        assert np.array_equal(fm.bwt_words, tiny_fm.bwt_words)
        assert np.array_equal(fm.cp_occ, tiny_fm.cp_occ)
        assert np.array_equal(fm.sa_sampled, tiny_fm.sa_sampled)
        assert np.array_equal(fm.pac, tiny_fm.pac)
        assert [a.name for a in fm.bns.anns] == \
            [a.name for a in tiny_fm.bns.anns]
        # queries through the attached copy are identical
        from compseed.cpu import fm_oracle as fo
        for k in (0, 1, 100, fm.seq_len - 1):
            assert np.array_equal(fo.occ4(fm, k), fo.occ4(tiny_fm, k))
    finally:
        shm.shm_destroy("pytest_tiny")
    assert not shm.shm_available("pytest_tiny")

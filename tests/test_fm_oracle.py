"""Scalar FM-index oracle vs brute force on a micro genome."""

import numpy as np

from compseed.cpu import fm_oracle as fo
from compseed.index.suffix import suffix_array


def _bwt_string(built):
    return built.bwt_codes


def test_occ4_vs_naive(micro):
    seq, built, fm = micro
    bwt = _bwt_string(built)
    rng = np.random.default_rng(5)
    ks = list(rng.integers(0, fm.seq_len, size=64)) + [0, fm.seq_len - 1]
    for k in ks:
        k = int(k)
        kk = k - 1 if k >= fm.primary else k
        naive = np.bincount(bwt[: kk + 1], minlength=4)
        got = fo.occ4(fm, k)
        assert np.array_equal(got, naive), k


def test_invpsi_sa_vs_full_sa(micro):
    seq, built, fm = micro
    both = np.concatenate([seq, 3 - seq[::-1]])
    sa_full = suffix_array(both)
    rng = np.random.default_rng(6)
    for k in rng.integers(0, fm.seq_len + 1, size=100):
        k = int(k)
        assert fo.sa_lookup(fm, k) == int(sa_full[k]), k


def test_extend_matches_counting(micro):
    """bwt_extend children must equal brute-force pattern counting."""
    seq, built, fm = micro
    both = np.concatenate([seq, 3 - seq[::-1]])
    text = bytes(both)

    def count(pat: bytes) -> int:
        n = 0
        start = 0
        while True:
            i = text.find(pat, start)
            if i < 0:
                return n
            n += 1
            start = i + 1

    rng = np.random.default_rng(8)
    for _ in range(20):
        plen = int(rng.integers(1, 6))
        pos = int(rng.integers(0, len(seq) - plen))
        pat = seq[pos: pos + plen]
        # compute the bi-interval by backward extension from the last base
        ik = fo.set_intv(fm, int(pat[-1]))
        for j in range(plen - 2, -1, -1):
            ik = fo.extend(fm, ik, 1)[int(pat[j])]
        assert ik[2] == count(bytes(pat)), pat
        # forward extension with one more base must equal counting as well
        nxt = int(rng.integers(0, 4))
        ok = fo.extend(fm, ik, 0)
        ext = np.concatenate([pat, np.array([nxt], dtype=np.uint8)])
        assert ok[3 - nxt, 2] == count(bytes(ext))


def _brute_smems(both: np.ndarray, q: np.ndarray, pivot: int, min_intv: int):
    """All maximal exact matches covering pivot with occ >= min_intv."""
    text = bytes(both)

    def cnt(b, e):
        if e <= b:
            return 10 ** 9
        pat = bytes(q[b:e])
        if 4 in q[b:e]:
            return 0
        n, start = 0, 0
        while True:
            i = text.find(pat, start)
            if i < 0:
                return n
            n += 1
            start = i + 1

    out = []
    L = len(q)
    for b in range(pivot + 1):
        for e in range(pivot + 1, L + 1):
            if cnt(b, e) >= min_intv:
                if (b == 0 or cnt(b - 1, e) < min_intv) and \
                   (e == L or cnt(b, e + 1) < min_intv):
                    out.append((b, e, cnt(b, e)))
    # drop contained matches
    out = [m for m in out
           if not any((o[0] <= m[0] and m[1] <= o[1] and o != m) for o in out)]
    return sorted(out)


def test_collect_mem_vs_brute(micro):
    seq, built, fm = micro
    both = np.concatenate([seq, 3 - seq[::-1]])
    rng = np.random.default_rng(9)
    for trial in range(12):
        pos = int(rng.integers(0, len(seq) - 40))
        q = seq[pos: pos + 40].copy()
        # add mismatches so multiple SMEMs arise
        for _ in range(3):
            j = int(rng.integers(0, 40))
            q[j] = int(rng.integers(0, 4))
        pivot = int(rng.integers(0, 35))
        mems, ret = fo.collect_mem(fm, q, pivot, 1)
        got = sorted((m[3], m[4], m[2]) for m in mems)
        want = _brute_smems(both, q, pivot, 1)
        assert got == want, (trial, got, want)
        assert ret > pivot

"""DP kernels vs brute-force full-matrix DP."""

import numpy as np

from compseed.cpu import ksw
from compseed.options import fill_scmat


MAT = np.array(fill_scmat(1, 4))


def _naive_global(q, t, o_del, e_del, o_ins, e_ins):
    """Unbanded affine-gap global alignment score (Gotoh)."""
    INF = 10 ** 9
    n, m = len(t), len(q)
    H = np.full((n + 1, m + 1), -INF, dtype=np.int64)
    E = np.full((n + 1, m + 1), -INF, dtype=np.int64)  # gap in target (del)
    F = np.full((n + 1, m + 1), -INF, dtype=np.int64)  # gap in query (ins)
    H[0, 0] = 0
    mat = MAT.reshape(5, 5)
    for j in range(1, m + 1):
        H[0, j] = -(o_ins + e_ins * j)
    for i in range(1, n + 1):
        H[i, 0] = -(o_del + e_del * i)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            E[i, j] = max(E[i - 1, j] - e_del, H[i - 1, j] - o_del - e_del)
            F[i, j] = max(F[i, j - 1] - e_ins, H[i, j - 1] - o_ins - e_ins)
            H[i, j] = max(H[i - 1, j - 1] + mat[t[i - 1], q[j - 1]],
                          E[i, j], F[i, j])
    return int(H[n, m])


def _naive_local(q, t, o_del, e_del, o_ins, e_ins):
    n, m = len(t), len(q)
    H = np.zeros((n + 1, m + 1), dtype=np.int64)
    E = np.zeros((n + 1, m + 1), dtype=np.int64)
    F = np.zeros((n + 1, m + 1), dtype=np.int64)
    best = 0
    mat = MAT.reshape(5, 5)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            E[i, j] = max(E[i - 1, j] - e_del, H[i - 1, j] - o_del - e_del, 0)
            F[i, j] = max(F[i, j - 1] - e_ins, H[i, j - 1] - o_ins - e_ins, 0)
            H[i, j] = max(H[i - 1, j - 1] + mat[t[i - 1], q[j - 1]],
                          E[i, j], F[i, j], 0)
            best = max(best, int(H[i, j]))
    return best


def test_global_vs_naive():
    rng = np.random.default_rng(11)
    for _ in range(15):
        n = int(rng.integers(5, 40))
        t = rng.integers(0, 4, size=n).astype(np.uint8)
        q = t.copy()
        for _ in range(int(rng.integers(0, 4))):
            q[int(rng.integers(0, n))] = int(rng.integers(0, 4))
        score, cigar = ksw.global_align(len(q), q, len(t), t, MAT,
                                        6, 1, 6, 1, w=50)
        naive = _naive_global(q, t, 6, 1, 6, 1)
        assert score == naive
        # cigar consumes both sequences fully
        assert sum(l for op, l in cigar if op in (0, 1)) == len(q)
        assert sum(l for op, l in cigar if op in (0, 2)) == len(t)


def test_local_vs_naive():
    rng = np.random.default_rng(12)
    for _ in range(10):
        q = rng.integers(0, 4, size=int(rng.integers(5, 30))).astype(np.uint8)
        t = rng.integers(0, 4, size=int(rng.integers(5, 30))).astype(np.uint8)
        got = ksw.local_score(len(q), q, len(t), t, MAT, 6, 1, 6, 1)
        assert got == _naive_local(q, t, 6, 1, 6, 1)


def test_extend_perfect_match():
    rng = np.random.default_rng(13)
    t = rng.integers(0, 4, size=60).astype(np.uint8)
    q = t[:40].copy()
    score, qle, tle, gtle, gscore, max_off = ksw.extend(
        len(q), q, len(t), t, MAT, 6, 1, 6, 1, w=100, end_bonus=5,
        zdrop=100, h0=19)
    # extension of a perfect 40bp match seeded with 19 scores 19+40
    assert score == 19 + 40
    assert (qle, tle) == (40, 40)
    assert gscore == 19 + 40  # reaches the query end
    assert max_off == 0

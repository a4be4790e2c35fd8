"""Reference-free reorder preprocessing (compseed.io.reorder)."""

import numpy as np

from compseed.io.reorder import _kmer_codes, reorder_indices, \
    reorder_reads


def _simulate(rng, glen=60_000, n=2_000, rl=101):
    genome = rng.integers(0, 4, glen).astype(np.uint8)
    pos = rng.integers(0, glen - rl, n)
    reads = np.empty((n, rl), np.uint8)
    for i, p in enumerate(pos):
        r = genome[p: p + rl].copy()
        err = rng.random(rl) < 0.005
        r[err] = rng.integers(0, 4, int(err.sum()))
        if rng.random() < 0.5:
            r = 3 - r[::-1]
        reads[i] = r
    return reads


def _adjacency(m, k=31):
    """Fraction of consecutive reads sharing a canonical k-mer."""
    fwd, rev, ok = _kmer_codes(m, k)
    can = np.where(ok, np.minimum(fwd, rev), 0)
    cs = np.sort(can, axis=1)
    share = 0
    for i in range(len(m) - 1):
        a, b = cs[i], cs[i + 1]
        ix = np.clip(np.searchsorted(a, b), 0, len(a) - 1)
        if np.any((a[ix] == b) & (b != 0)):
            share += 1
    return share / (len(m) - 1)


def test_reorder_is_permutation():
    rng = np.random.default_rng(11)
    reads = _simulate(rng, n=500)
    order = reorder_indices(reads)
    assert sorted(order.tolist()) == list(range(len(reads)))


def test_reorder_recovers_overlap_structure():
    rng = np.random.default_rng(12)
    # ~30x coverage — the workload class the compressors target
    reads = _simulate(rng, glen=20_000, n=6_000)
    shuf = reads[rng.permutation(len(reads))]
    before = _adjacency(shuf)
    after = _adjacency(shuf[reorder_indices(shuf)])
    # content-only clustering must recover most of the overlap adjacency
    assert before < 0.2
    assert after > 0.5, (before, after)


def test_reorder_deterministic_and_content_only():
    rng = np.random.default_rng(13)
    reads = _simulate(rng, n=300)
    p = rng.permutation(len(reads))
    shuf = reads[p]
    o1 = reorder_indices(shuf)
    o2 = reorder_indices(shuf)
    assert np.array_equal(o1, o2)
    # permuting the input permutes the output identically (order is a
    # function of content, not of input position)
    out_a = [tuple(r) for r in shuf[o1]]
    o3 = reorder_indices(reads)
    out_b = [tuple(r) for r in reads[o3]]
    assert out_a == out_b


def test_reorder_handles_ambiguous_and_short():
    rng = np.random.default_rng(14)
    reads = _simulate(rng, n=64)
    reads[0, :] = 4                      # all-N read
    reads[1, 10:40] = 4
    order = reorder_indices(reads)
    assert sorted(order.tolist()) == list(range(64))
    # string wrapper
    from compseed.utils import NT4_TO_ASCII
    seqs = [bytes(NT4_TO_ASCII[r]).decode() for r in reads]
    order2 = reorder_reads(seqs)
    assert sorted(order2) == list(range(64))

"""Device FM-index kernels vs the scalar oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from compseed.cpu import fm_oracle as fo
from compseed.ops import fm as dfm
from compseed.ops.device_index import to_device


@pytest.fixture(scope="module")
def dev(micro):
    seq, built, fm = micro
    return seq, fm, to_device(fm)


def test_occ4_batch(dev):
    seq, fm, dfi = dev
    rng = np.random.default_rng(21)
    ks = np.concatenate([rng.integers(0, fm.seq_len, size=200),
                         [-1, 0, fm.seq_len - 1, fm.primary,
                          fm.primary - 1, fm.primary + 1]]).astype(np.int64)
    got = np.asarray(dfm.occ4_batch(dfi, jnp.asarray(ks)))
    for i, k in enumerate(ks):
        want = fo.occ4(fm, int(k) if k != -1 else fo.NEG1)
        assert np.array_equal(got[i], want), k


def test_extend_batch(dev):
    seq, fm, dfi = dev
    rng = np.random.default_rng(22)
    # random valid bi-intervals obtained by backward search of short patterns
    iks = []
    for _ in range(50):
        plen = int(rng.integers(1, 8))
        pos = int(rng.integers(0, len(seq) - plen))
        pat = seq[pos: pos + plen]
        ik = fo.set_intv(fm, int(pat[-1]))
        for j in range(plen - 2, -1, -1):
            nxt = fo.extend(fm, ik, 1)[int(pat[j])]
            if nxt[2] == 0:
                break
            ik = nxt
        iks.append(ik)
    iks = np.stack(iks)
    for is_back in (0, 1):
        got = np.asarray(dfm.extend_batch(dfi, jnp.asarray(iks), is_back))
        for i in range(len(iks)):
            want = fo.extend(fm, iks[i], is_back)
            assert np.array_equal(got[i], want), (i, is_back)


def test_extend_sel_batch(dev):
    """extend_sel_batch(ik, c) == extend_batch(ik)[:, c, :] for every
    base and both directions (the fused one-child op the walk loops
    use to avoid per-step gather floors)."""
    seq, fm, dfi = dev
    rng = np.random.default_rng(24)
    iks = []
    for _ in range(64):
        plen = int(rng.integers(1, 8))
        pos = int(rng.integers(0, len(seq) - plen))
        pat = seq[pos: pos + plen]
        ik = fo.set_intv(fm, int(pat[-1]))
        for j in range(plen - 2, -1, -1):
            nxt = fo.extend(fm, ik, 1)[int(pat[j])]
            if nxt[2] == 0:
                break
            ik = nxt
        iks.append(ik)
    iks = np.stack(iks)
    cs = rng.integers(0, 4, size=len(iks)).astype(np.int32)
    for is_back in (0, 1):
        full = np.asarray(dfm.extend_batch(dfi, jnp.asarray(iks), is_back))
        got = np.asarray(dfm.extend_sel_batch(
            dfi, jnp.asarray(iks), jnp.asarray(cs), is_back))
        want = full[np.arange(len(iks)), cs]
        assert np.array_equal(got, want), is_back


def test_sa_batch(dev):
    seq, fm, dfi = dev
    rng = np.random.default_rng(23)
    ks = rng.integers(0, fm.seq_len + 1, size=300).astype(np.int64)
    got = np.asarray(dfm.sa_batch(dfi, jnp.asarray(ks)))
    for i, k in enumerate(ks):
        assert got[i] == fo.sa_lookup(fm, int(k)), k


def test_densify_sa(dev):
    """Device SA resampling (intv 32 -> 8/4) must equal the directly
    built denser sample bit-for-bit (incl. the -1 sentinel at [0]) and
    keep sa_batch oracle-exact on the densified index."""
    import os
    import tempfile
    from compseed.index.build import build_index
    from compseed.index.fmindex import FMIndex
    from compseed.ops.device_index import densify_sa
    from compseed.utils import NT4_TO_ASCII

    seq, fm, dfi = dev
    assert fm.sa_intv == 32
    for new_intv in (8, 4):
        dfi_d = densify_sa(dfi, new_intv, chunk=64)   # exercise chunking
        assert dfi_d.sa_intv == new_intv
        with tempfile.NamedTemporaryFile("w", suffix=".fa",
                                         delete=False) as f:
            f.write(">micro\n" + bytes(NT4_TO_ASCII[seq]).decode() + "\n")
            path = f.name
        fm_d = FMIndex.from_built(build_index(path, sa_intv=new_intv))
        os.unlink(path)
        want = fm_d.sa_sampled.astype(np.int64).astype(dfi.idx_dtype)
        assert np.array_equal(np.asarray(dfi_d.sa_sampled), want), new_intv
        ks = np.arange(0, fm.seq_len + 1, dtype=np.int64)
        got = np.asarray(dfm.sa_batch(dfi_d, jnp.asarray(ks)))
        for k in range(0, fm.seq_len + 1, 7):
            assert got[k] == fo.sa_lookup(fm, k), (new_intv, k)


def test_occ4_jit_int32(dev):
    seq, fm, dfi = dev
    assert dfi.dtype == jnp.int32  # micro genome fits int32
    f = jax.jit(lambda k: dfm.occ4_batch(dfi, k))
    ks = jnp.arange(0, 512, dtype=jnp.int32)
    out1 = f(ks)
    out2 = dfm.occ4_batch(dfi, ks)
    assert np.array_equal(np.asarray(out1), np.asarray(out2))



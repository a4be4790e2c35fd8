"""Batched FMD-index queries on device.

Contracts (exact integer semantics, validated against cpu.fm_oracle):
  occ4_batch    — bwt_occ4 (FM_index/bwt.c:169-186)
  extend_batch  — bwt_extend (FM_index/bwt.c:262-275)
  sa_batch      — bwt_sa via inverse-Psi walk (FM_index/bwt.c:53-96)

Design: one occ query gathers ONE fused 48-byte row (checkpoint counts +
2-bit BWT bitplanes, see ops.device_index) and ranks in-block bases with
masked popcounts — random row gathers dominate every FM operation, so
the layout minimizes gathers per query.  All batch shapes are
static; invalid lanes are masked with k == -1 which the reference also
treats as "count zero".
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from compseed.ops.device_index import DeviceFMIndex

_U1 = jnp.uint32(0xFFFFFFFF)


def _row_fetch(fm: DeviceFMIndex, k):
    """Gather fused rows for positions k; returns (cnt4, hi4, lo4, off).

    k must already be $-adjusted and clamped valid (>= 0)."""
    block = (k >> 7).astype(jnp.int32)
    off = (k & 0x7F).astype(jnp.int32)
    rows = jnp.take(fm.occ_rows, block, axis=0)  # (..., 12) uint32
    return rows[..., 0:4], rows[..., 4:8], rows[..., 8:12], off


def _rank4(cnt, hi, lo, off, dt):
    """Counts of each base among block positions 0..off inclusive."""
    word = jnp.arange(4, dtype=jnp.int32)
    nbits = jnp.clip(off[..., None] - (word << 5) + 1, 0, 32)
    full = nbits >= 32
    mask = jnp.where(full, _U1,
                     (jnp.uint32(1) << nbits.astype(jnp.uint32))
                     - jnp.uint32(1))
    hm = hi & mask
    lm = lo & mask
    pc = jax.lax.population_count
    c3 = pc(hm & lm).sum(-1)
    c2 = pc(hm & (~lm & mask)).sum(-1)
    c1 = pc((~hm & mask) & lm).sum(-1)
    c0 = pc((~hm & mask) & (~lm & mask)).sum(-1)
    return cnt.astype(dt) + jnp.stack([c0, c1, c2, c3],
                                      axis=-1).astype(dt)


def occ4_batch(fm: DeviceFMIndex, k: jax.Array) -> jax.Array:
    """Counts of each base in BWT[0..k] inclusive. k: (...,) -> (..., 4).

    k == -1 lanes return zeros (bwt.c:173-175).
    """
    dt = fm.dtype
    k = k.astype(dt)
    valid = k != -1
    kk = jnp.where(valid, k - (k >= fm.primary).astype(dt), 0)
    cnt, hi, lo, off = _row_fetch(fm, kk)
    out = _rank4(cnt, hi, lo, off, dt)
    return jnp.where(valid[..., None], out, jnp.zeros_like(out))


def _occ4_pair(fm: DeviceFMIndex, ka: jax.Array, kb: jax.Array):
    """occ4 at two positions with one fused gather batch."""
    dt = fm.dtype
    both = jnp.stack([ka, kb], axis=-1).astype(dt)       # (..., 2)
    valid = both != -1
    kk = jnp.where(valid, both - (both >= fm.primary).astype(dt), 0)
    cnt, hi, lo, off = _row_fetch(fm, kk)                # (..., 2, 4)
    out = _rank4(cnt, hi, lo, off, dt)
    out = jnp.where(valid[..., None], out, jnp.zeros_like(out))
    return out[..., 0, :], out[..., 1, :]


def extend_batch(fm: DeviceFMIndex, ik: jax.Array, is_back: bool) -> jax.Array:
    """Bidirectional extension. ik: (..., 3) -> ok: (..., 4, 3).

    ok[..., c, :] is the child bi-interval for base c.
    """
    dt = fm.dtype
    ik = ik.astype(dt)
    fwd = 1 - int(bool(is_back))  # coordinate being searched (x[!is_back])
    bwd = 1 - fwd
    x = ik[..., fwd]
    s = ik[..., 2]
    tk, tl = _occ4_pair(fm, x - 1, x - 1 + s)
    sizes = tl - tk                             # (..., 4)
    coord_f = fm.L2[:4] + 1 + tk                # (..., 4)
    contains_primary = ((x <= fm.primary) &
                        (x + s - 1 >= fm.primary)).astype(dt)
    b3 = ik[..., bwd] + contains_primary
    b2 = b3 + sizes[..., 3]
    b1 = b2 + sizes[..., 2]
    b0 = b1 + sizes[..., 1]
    coord_b = jnp.stack([b0, b1, b2, b3], axis=-1)
    ok = jnp.zeros(ik.shape[:-1] + (4, 3), dtype=dt)
    ok = ok.at[..., fwd].set(coord_f)
    ok = ok.at[..., bwd].set(coord_b)
    ok = ok.at[..., 2].set(sizes)
    return ok


def _sel4(arr4, c):
    """arr4[..., c] for per-lane c in [0,3] WITHOUT a gather op: a
    4-way masked sum lowers to VPU selects (take_along_axis emits a
    general gather, which pays this platform's per-op gather floor in
    every step of the seeding walk loops)."""
    c = c.astype(jnp.int32)
    out = jnp.zeros(arr4.shape[:-1], arr4.dtype)
    for b in range(4):
        out = out + jnp.where(c == b, arr4[..., b],
                              jnp.zeros_like(out))
    return out


def extend_sel_batch(fm: DeviceFMIndex, ik: jax.Array, c: jax.Array,
                     is_back: bool) -> jax.Array:
    """One-child bidirectional extension: extend_batch followed by
    selecting child ``c`` per lane, fused — no (..., 4, 3) child
    tensor, no take_along_axis gather, no L2 table gather.  ik: (..., 3)
    bi-intervals, c: (...,) base codes in [0, 3] -> (..., 3).

    Bit-exact vs extend_batch(fm, ik, is_back)[..., c, :] (the walk
    loops' inner op; differentially tested in test_ops_fm)."""
    dt = fm.dtype
    ik = ik.astype(dt)
    fwd = 1 - int(bool(is_back))
    bwd = 1 - fwd
    x = ik[..., fwd]
    s = ik[..., 2]
    tk, tl = _occ4_pair(fm, x - 1, x - 1 + s)
    sizes = tl - tk                             # (..., 4)
    c = c.astype(jnp.int32)
    size_c = _sel4(sizes, c)
    # L2 per-lane without the tiny-table gather
    l2c = jnp.zeros(c.shape, dt)
    for b in range(4):
        l2c = l2c + jnp.where(c == b, fm.L2[b], jnp.zeros_like(l2c))
    coord_f = l2c + 1 + _sel4(tk, c)
    contains_primary = ((x <= fm.primary) &
                        (x + s - 1 >= fm.primary)).astype(dt)
    # coord_b(c) = ik[bwd] + primary-hole + sum of sizes of bases > c
    above = jnp.zeros(c.shape, dt)
    for b in range(1, 4):
        above = above + jnp.where(c < b, sizes[..., b],
                                  jnp.zeros_like(above))
    coord_b = ik[..., bwd] + contains_primary + above
    cols = [None, None, size_c]
    cols[fwd] = coord_f
    cols[bwd] = coord_b
    return jnp.stack(cols, axis=-1)


def inv_psi_batch(fm: DeviceFMIndex, k: jax.Array) -> jax.Array:
    """One LF step per lane (bwt_invPsi, bwt.c:53-59).  Requires k >= 0.

    ONE row gather serves both the BWT base and its rank: the base lives
    at x = k - (k > primary) and the occ rank is taken at
    kk = k - (k >= primary); x == kk everywhere except k == primary,
    whose result is overridden to 0 below (bwt.c:55), so the row at x
    is correct for both reads.
    """
    dt = fm.dtype
    k = k.astype(dt)
    x = k - (k > fm.primary).astype(dt)
    cnt_x, hi_x, lo_x, off_x = _row_fetch(fm, x)
    w = (off_x >> 5).astype(jnp.int32)
    b = (off_x & 31).astype(jnp.uint32)
    hw = jnp.take_along_axis(hi_x, w[..., None], axis=-1)[..., 0]
    lw = jnp.take_along_axis(lo_x, w[..., None], axis=-1)[..., 0]
    c = (((hw >> b) & 1) << 1 | ((lw >> b) & 1)).astype(jnp.int32)
    occ4 = _rank4(cnt_x, hi_x, lo_x, off_x, dt)
    occ = jnp.take_along_axis(occ4, c[..., None], axis=-1)[..., 0]
    res = fm.L2[c] + occ
    return jnp.where(k == fm.primary, jnp.zeros_like(res), res)


def bwt_b0_batch(fm: DeviceFMIndex, k: jax.Array) -> jax.Array:
    """Base at position k of the $-removed BWT (bwt_B0, bwt.h:80)."""
    _, hi, lo, off = _row_fetch(fm, k.astype(fm.dtype))
    w = (off >> 5).astype(jnp.int32)
    b = (off & 31).astype(jnp.uint32)
    hw = jnp.take_along_axis(hi, w[..., None], axis=-1)[..., 0]
    lw = jnp.take_along_axis(lo, w[..., None], axis=-1)[..., 0]
    return (((hw >> b) & 1) << 1 | ((lw >> b) & 1)).astype(jnp.int32)


def sa_batch(fm: DeviceFMIndex, k: jax.Array) -> jax.Array:
    """SA[k] per lane via masked inverse-Psi walk (bwt_sa, bwt.c:86-96).

    The walk ends when the psi-orbit hits a sampled row — the step count
    is unbounded in principle (geometric with mean ~sa_intv), so a while
    loop is required; each any()-condition check is a device-wide
    reduction the loop waits on, so the condition is checked only once
    per 2*sa_intv fully-masked steps.
    """
    dt = fm.dtype
    k = k.astype(dt)
    mask = fm.sa_intv - 1
    steps = jnp.zeros_like(k)

    def body(_, state):
        k, steps = state
        active = (k & mask) != 0
        k_next = inv_psi_batch(fm, k)
        k = jnp.where(active, k_next, k)
        steps = steps + active.astype(dt)
        return k, steps

    def seg(state):
        return jax.lax.fori_loop(0, 2 * fm.sa_intv, body, state)

    def cond(state):
        kk, _ = state
        return jnp.any((kk & mask) != 0)

    k, steps = jax.lax.while_loop(cond, seg, (k, steps))
    return steps + fm.sa_sampled[k // fm.sa_intv]


def sa_batch_compact(fm: DeviceFMIndex, k: jax.Array):
    """sa_batch with staged compaction: the walk length is geometric
    (mean ~sa_intv) with a long tail, so full-width lockstep pays the
    max walk (~10x sa_intv) on every lane.  Walk a few steps full-width,
    then argsort-compact the unfinished minority and continue narrow.

    Returns (sa (N,), ovf) — ovf set if stragglers exceeded a stage cap
    (caller falls back; caps leave ~8x headroom over the expected tail).
    """
    dt = fm.dtype
    i32 = jnp.int32
    N = k.shape[0]
    mask = fm.sa_intv - 1

    kk = k.astype(dt)
    steps = jnp.zeros(N, dt)
    slot = jnp.arange(N, dtype=i32)
    alive = (kk & mask) != 0

    out_steps = jnp.where(alive, jnp.zeros(N, dt), steps)
    out_k = kk
    ovf = jnp.asarray(False)

    def run(kk, steps, alive, n_steps):
        def body(_, st):
            kk, steps, alive = st
            k_next = inv_psi_batch(fm, kk)
            kk2 = jnp.where(alive, k_next, kk)
            steps2 = steps + alive.astype(dt)
            alive2 = alive & ((kk2 & mask) != 0)
            return kk2, steps2, alive2
        return jax.lax.fori_loop(0, n_steps, body, (kk, steps, alive))

    stages = ((1, fm.sa_intv), (4, 2 * fm.sa_intv), (16, 4 * fm.sa_intv),
              (64, 0))
    for div, n_steps in stages:
        cap = max(N // div, 1)
        if div > 1:
            order = jnp.argsort(~alive, stable=True)
            n_alive = jnp.sum(alive.astype(i32))
            ovf = ovf | (n_alive > cap)
            take = order[:cap]
            kk = kk[take]
            steps = steps[take]
            alive = alive[take]
            slot = slot[take]
        if n_steps == 0:
            def seg(st):
                return run(*st, 2 * fm.sa_intv)
            kk, steps, alive = jax.lax.while_loop(
                lambda st: jnp.any(st[2]), seg, (kk, steps, alive))
        else:
            kk, steps, alive = run(kk, steps, alive, n_steps)
        done = ~alive & (slot >= 0)
        sl = jnp.where(done, slot, N)
        out_steps = out_steps.at[sl].set(jnp.where(done, steps, 0),
                                         mode="drop")
        out_k = out_k.at[sl].set(jnp.where(done, kk, 0), mode="drop")
        slot = jnp.where(done, -1, slot)

    sa = out_steps + fm.sa_sampled[out_k // fm.sa_intv]
    return sa, ovf

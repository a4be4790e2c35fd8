"""On-device DP tile build for banded Smith-Waterman pairs.

The extension engine ships only ~48 B of metadata per pair to the
device; the query and target sequences of each pair are sliced here
from the chunk's device read matrix and the 2-bit packed reference.
Plain JAX; the DP itself is in ops/bsw.py (XLA) and ops/bsw_triton.py
(the GPU kernel).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def build_tiles_ref(qflat, pac, qmeta, r0, rlen, *, Q: int, T: int,
                    L: int, l_pac: int):
    """Per-element reference formulation of the tile build (one gather
    per tile CELL) — kept as the differential oracle for build_tiles.
    Semantics: queries out of the chunk's read matrix, targets out of
    the packed reference with the forward/reverse fold pf = gp < l_pac
    ? gp : 2*l_pac-1-gp and complement on the mirrored side; rev pairs
    consume positions downward (the reference's reversed-copy left
    extension, comp_seed.cpp:630-637)."""
    i32 = jnp.int32
    rid = qmeta[:, 0]
    q0 = qmeta[:, 1]
    ql = qmeta[:, 2]
    rev = qmeta[:, 3]
    sign = jnp.where(rev == 1, -1, 1).astype(i32)
    j = jnp.arange(Q, dtype=i32)
    qpos = q0[:, None] + sign[:, None] * j[None, :]
    flat = rid[:, None] * L + qpos
    inq = j[None, :] < ql[:, None]
    qt = jnp.where(
        inq, qflat[jnp.clip(flat, 0, qflat.shape[0] - 1)], 4)
    j2 = jnp.arange(T, dtype=i32)
    gp = r0[:, None] + (sign[:, None] * j2[None, :]).astype(r0.dtype)
    fwd = gp < l_pac
    pf = jnp.where(fwd, gp, 2 * l_pac - 1 - gp)
    from compseed.ops.device_index import pac_codes_at
    tv = pac_codes_at(pac, pf).astype(i32)
    tv = jnp.where(fwd, tv, 3 - tv)
    tt = jnp.where(j2[None, :] < rlen[:, None], tv, 4)
    return qt.astype(jnp.int8), ql, tt.astype(jnp.int8)


_SH_ASC = np.array([8 * (t >> 2) + 2 * (3 - (t & 3))
                    for t in range(16)], np.uint32)


def _pac_run(pac, start, d, K: int, T: int, n_words: int):
    """Decode T reference codes per lane along the affine position run
    pf(j) = start + d*j (d: per-lane +/-1) from the 2-bit packed pac
    words, with K word gathers per lane instead of T element gathers.

    Words are gathered along the run direction; each unpacks to 16
    codes in j-order (reversed within-word for descending lanes),
    giving a (P, 16*K) code strip whose lane offset is start & 15 (or
    its mirror); a 16-way static-shift select aligns j = 0.  Exact for
    any start (out-of-range words clip; callers mask the elements)."""
    i32 = jnp.int32
    k = jnp.arange(K, dtype=i32)[None, :]
    w0 = (start >> 4).astype(i32)[:, None]
    widx = jnp.clip(w0 + d[:, None] * k, 0, n_words - 1)
    words = pac[widx]                                    # (P, K) u32
    pos = d[:, None] == 1
    asc = ((words[:, :, None] >> _SH_ASC[None, None, :])
           & np.uint32(3)).astype(jnp.int8)              # (P, K, 16)
    strip = jnp.where(pos[:, :, None], asc, asc[:, :, ::-1]) \
        .reshape(words.shape[0], 16 * K)
    off = jnp.where(pos[:, 0], (start & 15).astype(i32),
                    15 - (start & 15).astype(i32))
    out = jnp.zeros((words.shape[0], T), jnp.int8)
    for o in range(16):
        out = jnp.where((off == o)[:, None], strip[:, o:o + T], out)
    return out


def build_tiles(qflat, pac, qmeta, r0, rlen, *, Q: int, T: int, L: int,
                l_pac: int):
    """Packed-word tile build — bit-exact twin of build_tiles_ref
    (differential test test_build_tiles_packed) at ~6x fewer gathered
    elements: queries gather 3-bit 8-char window words (one word per 8
    cells, from packed_windows / packed_rev_windows of the read
    matrix), targets gather 2-bit pac words along BOTH fold branches
    (pf is piecewise-affine with one knee at the strand mirror; each
    branch is one affine word run, elements select their branch by
    gp < l_pac).  Returns (qt, ql, tt) with qt (P, Q) / tt (P, T)
    int8."""
    from compseed.ops.seedscan import (packed_rev_windows,
                                       packed_windows)
    i32 = jnp.int32
    rid = qmeta[:, 0]
    q0 = qmeta[:, 1]
    ql = qmeta[:, 2]
    rev = qmeta[:, 3]
    sign = jnp.where(rev == 1, -1, 1).astype(i32)
    P = rid.shape[0]

    # ---- queries: one 8-char window word per 8 cells.  Forward lanes
    # read packed_windows (chars p..p+7), reverse lanes read
    # packed_rev_windows (chars p..p-7); the window START q0 +/- 8k is
    # exact, so no cross-word alignment select is needed.
    qarr = qflat.reshape(-1, L)
    fw = packed_windows(qarr, 8)                 # (R*(L+2),) u32
    bw = packed_rev_windows(qarr)                # (R*L,) u32
    qcat = jnp.concatenate([fw, bw])
    KQ = (Q + 7) // 8
    kq = jnp.arange(KQ, dtype=i32)[None, :]
    wposf = jnp.clip(q0[:, None] + 8 * kq, 0, L + 1)
    wposr = jnp.clip(q0[:, None] - 8 * kq, 0, L - 1)
    addr = jnp.where((rev == 1)[:, None],
                     fw.shape[0] + rid[:, None] * L + wposr,
                     rid[:, None] * (L + 2) + wposf)
    wq = qcat[jnp.clip(addr, 0, qcat.shape[0] - 1)]      # (P, KQ)
    qsh = np.array([3 * t for t in range(8)], np.uint32)
    qdec = ((wq[:, :, None] >> qsh[None, None, :])
            & np.uint32(7)).astype(jnp.int8)             # (P, KQ, 8)
    qt = qdec.reshape(P, 8 * KQ)[:, :Q]
    j = jnp.arange(Q, dtype=i32)
    inq = j[None, :] < ql[:, None]
    qt = jnp.where(inq, qt, jnp.int8(4))

    # ---- targets: both fold branches as affine word runs with
    # per-lane direction (pf has one knee at the strand mirror; each
    # element selects its branch by gp < l_pac)
    KT = T // 16 + 2
    n_words = pac.shape[0]
    mir = ((2 * l_pac - 1) - r0).astype(r0.dtype)
    A = _pac_run(pac, r0, sign, KT, T, n_words)
    B = _pac_run(pac, mir, -sign, KT, T, n_words)
    j2 = jnp.arange(T, dtype=i32)
    gp = r0[:, None] + (sign[:, None] * j2[None, :]).astype(r0.dtype)
    fwd = gp < l_pac
    tv = jnp.where(fwd, A, (3 - B).astype(jnp.int8))
    tt = jnp.where(j2[None, :] < rlen[:, None], tv, jnp.int8(4))
    return qt, ql, tt


def clamp_band(qlens: np.ndarray, w: int, max_sc: int, end_bonus: int,
               o_del: int, e_del: int, o_ins: int, e_ins: int) -> np.ndarray:
    """Per-pair band clamp (ksw.c:398-407; C truncates from double)."""
    q = qlens.astype(np.float64)
    max_ins = np.maximum(((q * max_sc + end_bonus - o_ins) / e_ins
                          + 1.0).astype(np.int32), 1)
    max_del = np.maximum(((q * max_sc + end_bonus - o_del) / e_del
                          + 1.0).astype(np.int32), 1)
    return np.minimum(np.minimum(np.int32(w), max_ins), max_del)

"""Banded Smith-Waterman extension as a GPU kernel (Pallas, Triton route).

Same integer semantics as ops/bsw.py::_extend_core (== ksw_extend2,
bwalib/ksw.c:380-479, == scalarBandedSWA, mapping/bandedSWA.cpp:116-237),
laid out the way the reference lays out its SIMD kernel: one pair per
lane (mapping/bandedSWA.h:57-79).  A program owns BP pairs of a
target-length-sorted batch and walks target rows in a while loop that
ends at the block's own longest live target.  Within a row it sweeps the
query columns as ksw_extend2 does, so the F recurrence and the row max
are the scalar ones, carried in registers per lane.  H and E live in a
column-major ([column][pair]) state buffer, so the BP lanes of a column
are one coalesced row.

Both band rounds of the band-doubling retry and the acceptance test
between them (comp_seed.cpp:1732-1767) run in the same launch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BP = 128          # pairs (lanes) per program: one per thread at 4 warps

_i32 = jnp.int32


def _c(v):
    return jnp.asarray(v, _i32)


def _row(ref, j):
    """Row j of a column-major block: the BP lanes of one column.  Both
    indices int32 (with x64 on, a bare 0 would trace as int64)."""
    return ref.at[j, pl.ds(_c(0), BP)]


def _ld(ref, j):
    return plgpu.load(_row(ref, j))


def _st(ref, j, val, mask=None):
    plgpu.store(_row(ref, j), val, mask=mask)


def _kernel(qt_ref, tt_ref, meta_ref, out_ref, h_ref, e_ref, *, mat,
            o_del, e_del, o_ins, e_ins, zdrop, w0, Q, T):
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    qlen = _ld(meta_ref, _c(0))
    tlen0 = _ld(meta_ref, _c(1))
    h0 = _ld(meta_ref, _c(2))
    prev = _ld(meta_ref, _c(3))
    zero = jnp.zeros((BP,), _i32)
    neg1 = jnp.full((BP,), -1, _i32)

    def dp(tlen, w):
        def init_col(j, c):
            v = jnp.maximum(h0 - oe_ins - (j - 1) * e_ins, 0)
            hj = jnp.where(j == 0, h0, v)
            _st(h_ref, j, jnp.where(j <= qlen, hj, 0))
            _st(e_ref, j, zero)
            return c

        jax.lax.fori_loop(_c(0), _c(Q), init_col, _c(0))

        def cond(st):
            i, broken = st[0], st[-1]
            live = jnp.where((broken == 0) & (i < tlen), 1, 0).astype(_i32)
            return (i < T) & (jnp.max(live) > 0)

        def row(st):
            i, beg, end, best, max_i, max_j, max_ie, gscore, max_off, \
                broken = st
            active = (broken == 0) & (i < tlen)
            beg_i = jnp.maximum(beg, i - w)
            end_i = jnp.minimum(jnp.minimum(end, i + w + 1), qlen)
            h_first = jnp.where(
                beg_i == 0, jnp.maximum(h0 - (o_del + e_del * (i + 1)), 0),
                0)
            tc = _ld(tt_ref, i).astype(_i32)
            # this row's score per query code: srow[c] = mat[tc][c]
            srow = []
            for c in range(5):
                s = jnp.full((BP,), mat[4 * 5 + c], _i32)
                for t in range(4):
                    s = jnp.where(tc == t, mat[t * 5 + c], s)
                srow.append(s)

            def col(j, cst):
                h1, f, m, mj, first, last = cst
                jr = jnp.minimum(j, Q - 1)
                inb = active & (j >= beg_i) & (j < end_i)
                at_end = active & (j == end_i)
                hd = _ld(h_ref, jr)                 # H(i-1, j-1)
                ed = _ld(e_ref, jr)                 # E(i, j)
                qc = _ld(qt_ref, jr).astype(_i32)
                sc = srow[4]
                for q in range(4):
                    sc = jnp.where(qc == q, srow[q], sc)
                M = jnp.where(hd != 0, hd + sc, 0)
                h = jnp.maximum(jnp.maximum(M, ed), f)
                e_new = jnp.maximum(ed - e_del, jnp.maximum(M - oe_del, 0))
                f_new = jnp.maximum(f - e_ins, jnp.maximum(M - oe_ins, 0))
                # column j of the next row: H(i, j-1) and E(i+1, j); at
                # the band end (ksw.c:449) h1 with a zero E
                e_st = jnp.where(inb, e_new, 0)
                wr = (inb | at_end) & (j < Q)
                _st(h_ref, jr, h1, mask=wr)
                _st(e_ref, jr, e_st, mask=wr)
                # non-zero span of the stored row for the band shrink
                nz = (h1 != 0) | (e_st != 0)
                first = jnp.where(inb & nz & (first > j), j, first)
                last = jnp.where((inb | at_end) & nz, j, last)
                # row max and its LAST column (ksw.c:437-438)
                mj = jnp.where(inb & (h >= m), j, mj)
                m = jnp.where(inb, jnp.maximum(m, h), m)
                h1 = jnp.where(inb, h, h1)
                f = jnp.where(inb, f_new, f)
                return h1, f, m, mj, first, last

            h1, _, m, mj, first, last = jax.lax.fori_loop(
                _c(0), _c(Q + 1), col,
                (h_first, zero, zero, neg1,
                 jnp.full((BP,), Q + 1, _i32), neg1))

            # to-query-end score (ksw.c:450-453)
            at_qend = active & (end_i == qlen)
            max_ie = jnp.where(at_qend & (gscore <= h1), i, max_ie)
            gscore = jnp.where(at_qend, jnp.maximum(gscore, h1), gscore)

            # break / best / z-drop (ksw.c:454-463)
            better = m > best
            upd = active & better
            brk = m == 0
            if zdrop > 0:
                di = i - max_i
                dj = mj - max_j
                zd = jnp.where(di > dj,
                               best - m - (di - dj) * e_del > zdrop,
                               best - m - (dj - di) * e_ins > zdrop)
                brk = brk | (~better & zd)
            off = jnp.maximum(mj - i, i - mj)
            max_off = jnp.where(upd, jnp.maximum(max_off, off), max_off)
            best = jnp.where(upd, m, best)
            max_i = jnp.where(upd, i, max_i)
            max_j = jnp.where(upd, mj, max_j)
            broken = jnp.where(active & brk, 1, broken)

            # band shrink to the non-zero span (ksw.c:465-469)
            keep = active & ~brk
            beg_new = jnp.minimum(first, end_i)
            last = jnp.where(last >= beg_new, last, beg_new - 1)
            beg = jnp.where(keep, beg_new, beg)
            end = jnp.where(keep, jnp.minimum(last + 2, qlen), end)
            return (i + 1, beg, end, best, max_i, max_j, max_ie, gscore,
                    max_off, broken)

        st = jax.lax.while_loop(
            cond, row,
            (_c(0), zero, qlen, h0, neg1, neg1, neg1, neg1, zero, zero))
        _, _, _, best, max_i, max_j, max_ie, gscore, max_off, _ = st
        return (best, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off)

    r0 = dp(tlen0, _ld(meta_ref, _c(4)))
    accept = (r0[0] == prev) | (r0[5] < ((w0 >> 1) + (w0 >> 2)))
    r1 = dp(jnp.where(accept, 0, tlen0), _ld(meta_ref, _c(5)))
    for k in range(6):
        _st(out_ref, _c(k), jnp.where(accept, r0[k], r1[k]))
    _st(out_ref, _c(6), jnp.where(accept, 0, 1).astype(_i32))
    _st(out_ref, _c(7), zero)


@functools.partial(jax.jit, static_argnames=(
    "mat", "o_del", "e_del", "o_ins", "e_ins", "zdrop", "w0", "interpret"))
def bsw_dual_kernel(qt, tt, meta, *, mat: tuple, o_del: int, e_del: int,
                    o_ins: int, e_ins: int, zdrop: int, w0: int,
                    interpret: bool = False) -> jax.Array:
    """Both band rounds + acceptance for P pairs (P a multiple of BP).

    qt: (Q, P) int8 query codes, tt: (T, P) int8 target codes, both
    column-major and padded with 4; meta: (8, P) int32 rows qlen, tlen,
    h0, prev_score, band round 0, band round 1.  mat: the 5x5 scoring
    matrix flattened.  Returns (8, P) int32: score, qle, tle, gtle,
    gscore, max_off of the accepted round, then the round index."""
    Q, P = qt.shape
    T = tt.shape[0]
    kern = functools.partial(
        _kernel, mat=tuple(int(x) for x in mat), o_del=o_del, e_del=e_del,
        o_ins=o_ins, e_ins=e_ins, zdrop=zdrop, w0=w0, Q=Q, T=T)
    col = lambda rows: pl.BlockSpec((rows, BP), lambda g: (0, g))
    out, _, _ = pl.pallas_call(
        kern,
        grid=(P // BP,),
        in_specs=[col(Q), col(T), col(8)],
        out_specs=[col(8), col(Q), col(Q)],
        out_shape=[jax.ShapeDtypeStruct((8, P), _i32),
                   jax.ShapeDtypeStruct((Q, P), _i32),   # H state
                   jax.ShapeDtypeStruct((Q, P), _i32)],  # E state
        compiler_params=plgpu.CompilerParams(num_warps=BP // 32,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="bsw_dual",
    )(qt, tt, meta)
    return out


def mat_key(mat: np.ndarray) -> tuple:
    """Hashable scoring matrix for the kernel's static arguments."""
    return tuple(int(x) for x in np.asarray(mat).reshape(25))

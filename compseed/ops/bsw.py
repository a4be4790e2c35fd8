"""Batched banded Smith-Waterman extension on device.

Exact integer semantics of ksw_extend2 (bwalib/ksw.c:380-479) ==
scalarBandedSWA (mapping/bandedSWA.cpp:116-237), vectorized one-pair-per-
lane over the batch dimension (the reference's SSE/AVX lane packing,
mapping/bandedSWA.h:57-79) and scanned over target rows.  Everything that is data-dependent in the scalar code — adaptive
band [beg,end), z-drop, early break, last-argmax tie-breaking — is
reproduced with masks, so results are bit-identical to the oracle.

The F (gap-in-query) recurrence within a row is a max-plus prefix scan,
computed with a cumulative max over t + j*e_ins (O(row) vector work
instead of a sequential column loop).  This is the plain XLA program;
the GPU kernel (ops/bsw_triton.py) runs the same recurrence column by
column per lane.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from compseed.ops.tiles import clamp_band

NEG = -(1 << 29)


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5, 6))
def bsw_extend(o_del: int, e_del: int, o_ins: int, e_ins: int,
               zdrop: int, end_bonus: int, max_sc: int,
               mat: jax.Array,        # (5, 5) int32 scoring matrix
               w_in: jax.Array,       # () int32 band width this round
               queries: jax.Array,    # (P, Q) uint8, padded with 4
               qlens: jax.Array,      # (P,) int32
               targets: jax.Array,    # (P, T) uint8, padded with 4
               tlens: jax.Array,      # (P,) int32
               h0s: jax.Array,        # (P,) int32
               ):
    """Returns (score, qle, tle, gtle, gscore, max_off), each (P,) int32."""
    i32 = jnp.int32
    qlens = qlens.astype(i32)
    # per-pair band clamp (ksw.c:398-407); C computes in double then truncs
    max_ins = jnp.maximum(
        ((qlens.astype(jnp.float64) * max_sc + end_bonus - o_ins) / e_ins
         + 1.0).astype(i32), 1)
    max_del = jnp.maximum(
        ((qlens.astype(jnp.float64) * max_sc + end_bonus - o_del) / e_del
         + 1.0).astype(i32), 1)
    w = jnp.minimum(jnp.minimum(w_in.astype(i32), max_ins), max_del)  # (P,)
    return _extend_core(o_del, e_del, o_ins, e_ins, zdrop, mat, w,
                        queries, qlens, targets, tlens, h0s)


def _extend_core(o_del: int, e_del: int, o_ins: int, e_ins: int,
                 zdrop: int, mat, w, queries, qlens, targets, tlens, h0s):
    """DP body with the band already clamped per pair (w: (P,) int32)."""
    P, Q = queries.shape
    T = targets.shape[1]
    i32 = jnp.int32
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins

    qlens = qlens.astype(i32)
    tlens = tlens.astype(i32)
    h0s = h0s.astype(i32)
    w = w.astype(i32)

    jj = jnp.arange(Q + 1, dtype=i32)            # eh index grid
    jq = jnp.arange(Q, dtype=i32)                # column grid

    # first row init (ksw.c:395-397): h[j] = max(h0 - oe_ins - (j-1)e, 0)
    v = h0s[:, None] - oe_ins - (jj[None, :] - 1) * e_ins
    h = jnp.where(jj[None, :] == 0, h0s[:, None], jnp.maximum(v, 0))
    h = jnp.where(jj[None, :] <= qlens[:, None], h, 0).astype(i32)
    e = jnp.zeros((P, Q + 1), dtype=i32)

    # per-base query profiles, computed once; rows select by target char
    # (replaces a per-row 2D gather, which lowers poorly)
    qidx = queries.astype(i32)
    qprof = [mat[c][qidx] for c in range(5)]  # 5 x (P, Q)

    init = dict(
        h=h, e=e,
        beg=jnp.zeros(P, dtype=i32), end=qlens,
        best=h0s, max_i=jnp.full(P, -1, i32), max_j=jnp.full(P, -1, i32),
        max_ie=jnp.full(P, -1, i32), gscore=jnp.full(P, -1, i32),
        max_off=jnp.zeros(P, i32), broken=jnp.zeros(P, jnp.bool_),
    )

    def row_step(i, st):
        active = (~st["broken"]) & (i < tlens)
        beg = jnp.maximum(st["beg"], i - w)
        end = jnp.minimum(jnp.minimum(st["end"], i + w + 1), qlens)
        empty = end <= beg
        h_first = jnp.where(beg == 0,
                            jnp.maximum(h0s - (o_del + e_del * (i + 1)), 0),
                            0).astype(i32)

        tchar = targets[:, i].astype(i32)                     # (P,)
        score = qprof[4]
        for c in range(4):
            score = jnp.where((tchar == c)[:, None], qprof[c], score)

        inb = (jq[None, :] >= beg[:, None]) & (jq[None, :] < end[:, None])
        Hdiag = st["h"][:, :Q]
        Eprev = st["e"][:, :Q]
        M = jnp.where(Hdiag != 0, Hdiag + score, 0)
        e_new = jnp.maximum(Eprev - e_del, jnp.maximum(M - oe_del, 0))
        t_ins = jnp.maximum(M - oe_ins, 0)

        # F prefix scan with a pseudo source (value 0) at column beg-1:
        # T_arr[jj] = 0 at jj==beg, t[jj-1] inside the band, else -inf
        t_pad = jnp.concatenate(
            [jnp.full((P, 1), NEG, i32),
             jnp.where(inb, t_ins, NEG)], axis=1)              # (P, Q+1)
        t_src = jnp.where(jj[None, :] == beg[:, None], 0, t_pad)
        run = jax.lax.associative_scan(jnp.maximum,
                                       t_src + jj[None, :] * e_ins, axis=1)
        f = run[:, :Q] - jq[None, :] * e_ins                   # F entering col j

        h_new = jnp.maximum(jnp.maximum(M, Eprev), f)

        # row max and its LAST column (ksw.c:437-438 tie semantics)
        h_band = jnp.where(inb, h_new, 0)
        m = jnp.max(h_band, axis=1)                            # >= 0
        is_max = (h_band == m[:, None]) & inb
        mj = jnp.max(jnp.where(is_max, jq[None, :], -1), axis=1)
        mj = jnp.where(m == 0, -1, mj)

        # scatter the shifted row back: h[jj] = h_first at beg,
        # H(i, jj-1) for beg < jj <= end; e[jj] = e_new in band, 0 at end
        h_prev = jnp.concatenate([jnp.zeros((P, 1), i32), h_new], axis=1)
        upd1 = jj[None, :] == beg[:, None]
        upd2 = (jj[None, :] > beg[:, None]) & (jj[None, :] <= end[:, None])
        h_out = jnp.where(upd1, h_first[:, None],
                          jnp.where(upd2, h_prev, st["h"]))
        e_pad = jnp.concatenate([e_new, jnp.zeros((P, 1), i32)], axis=1)
        inb_e = (jj[None, :] >= beg[:, None]) & (jj[None, :] < end[:, None])
        e_out = jnp.where(inb_e, e_pad,
                          jnp.where(jj[None, :] == end[:, None], 0, st["e"]))
        h_out = jnp.where(active[:, None], h_out, st["h"])
        e_out = jnp.where(active[:, None], e_out, st["e"])

        # to-query-end score (ksw.c:450-453)
        h1_last = jnp.where(empty, h_first,
                            jnp.take_along_axis(
                                h_new, jnp.maximum(end - 1, 0)[:, None],
                                axis=1)[:, 0])
        at_qend = active & (end == qlens)
        upd_g = at_qend & (st["gscore"] <= h1_last)
        max_ie = jnp.where(upd_g, i, st["max_ie"])
        gscore = jnp.where(at_qend, jnp.maximum(st["gscore"], h1_last),
                           st["gscore"])

        # break / best / z-drop (ksw.c:454-463)
        brk0 = m == 0
        better = m > st["best"]
        best = jnp.where(active & better, m, st["best"])
        max_i = jnp.where(active & better, i, st["max_i"])
        max_j = jnp.where(active & better, mj, st["max_j"])
        max_off = jnp.where(active & better,
                            jnp.maximum(st["max_off"], jnp.abs(mj - i)),
                            st["max_off"])
        di = i - st["max_i"]
        dj = mj - st["max_j"]
        zd_del = st["best"] - m - (di - dj) * e_del > zdrop
        zd_ins = st["best"] - m - (dj - di) * e_ins > zdrop
        zd = jnp.where(di > dj, zd_del, zd_ins)
        brk = brk0 | ((~better) & (zdrop > 0) & zd)
        broken = st["broken"] | (active & brk)

        # band shrink to the non-zero span (ksw.c:465-469), on the
        # updated arrays; skipped for lanes that just broke
        nz = (h_out != 0) | (e_out != 0)
        c1 = nz & (jj[None, :] >= beg[:, None]) & (jj[None, :] < end[:, None])
        beg_new = jnp.min(jnp.where(c1, jj[None, :], end[:, None]), axis=1)
        c2 = nz & (jj[None, :] >= beg_new[:, None]) & \
            (jj[None, :] <= end[:, None])
        last = jnp.max(jnp.where(c2, jj[None, :], beg_new[:, None] - 1),
                       axis=1)
        end_new = jnp.minimum(last + 2, qlens)
        keep = active & ~brk
        beg = jnp.where(keep, beg_new, st["beg"])
        end_out = jnp.where(keep, end_new, st["end"])

        return dict(h=h_out, e=e_out, beg=beg, end=end_out, best=best,
                    max_i=max_i, max_j=max_j, max_ie=max_ie, gscore=gscore,
                    max_off=max_off, broken=broken)

    init["i"] = jnp.asarray(0, i32)

    def cond(st):
        return (st["i"] < T) & jnp.any((~st["broken"]) & (st["i"] < tlens))

    def body(st):
        i = st.pop("i")
        st = row_step(i, st)
        st["i"] = i + 1
        return st

    st = jax.lax.while_loop(cond, body, init)
    # single packed output: one device->host transfer for all six results
    return jnp.stack([st["best"], st["max_j"] + 1, st["max_i"] + 1,
                      st["max_ie"] + 1, st["gscore"], st["max_off"]])


def _meta_dual_core(mat: tuple, qflat, pac, meta, *, Q, T, L, l_pac,
                    o_del, e_del, o_ins, e_ins, zdrop, w0, kernel,
                    interpret=False, wide_r0=False):
    """Both band-doubling DP rounds + the retry acceptance in ONE device
    program: round 0 at the nominal band w0, the reference's acceptance
    test (score unchanged OR max_off < (w>>1)+(w>>2), comp_seed.cpp:
    1732-1767), then round 1 at 2*w0 only for rejected lanes (accepted
    lanes get tlen=0 and early-exit).  One host round trip per side
    instead of one per round.  meta columns: rid, q0, qlen, rev, r0_lo,
    r0_hi, rlen, h0, prev_score, ws0, ws1, pad.  ``kernel`` picks the DP:
    the GPU kernel (ops/bsw_triton.py; interpreted off the GPU) or the
    XLA program (_extend_core).  Returns (P, 8) int32: the six DP results of
    the accepted round + col 6 = accepted round index.  Shared by the
    single-device jit (bsw_meta_dual) and the shard_map composition
    (parallel/sharded.py)."""
    from compseed.ops.tiles import build_tiles
    qmeta = meta[:, 0:4]
    if wide_r0:
        r0 = (meta[:, 4].astype(jnp.uint32).astype(jnp.int64) |
              (meta[:, 5].astype(jnp.int64) << 32))
    else:
        r0 = meta[:, 4]
    rlen = meta[:, 6]
    qt, ql, tt = build_tiles(qflat, pac, qmeta, r0, rlen,
                             Q=Q, T=T, L=L, l_pac=l_pac)
    return dual_dp(mat, qt, ql.astype(jnp.int32), tt, rlen, meta[:, 7],
                   meta[:, 8], meta[:, 9], meta[:, 10], o_del=o_del,
                   e_del=e_del, o_ins=o_ins, e_ins=e_ins, zdrop=zdrop,
                   w0=w0, kernel=kernel, interpret=interpret)


def dual_dp(mat: tuple, qt, ql, tt, rlen, h0s, prev, ws0, ws1, *, o_del,
            e_del, o_ins, e_ins, zdrop, w0, kernel, interpret=False):
    """The DP of _meta_dual_core on built tiles: qt (P, Q) / tt (P, T)
    int8, the rest (P,) int32.  Returns (P, 8) int32.  kernel=False runs
    the XLA program: the CPU engine, and the plain reference the kernel
    is checked against."""
    i32 = jnp.int32
    if kernel:
        from compseed.ops.bsw_triton import bsw_dual_kernel
        z = jnp.zeros_like(rlen)
        kmeta = jnp.stack([ql, rlen, h0s, prev, ws0, ws1, z, z])
        return bsw_dual_kernel(
            qt.T, tt.T, kmeta, mat=mat, o_del=o_del, e_del=e_del,
            o_ins=o_ins, e_ins=e_ins, zdrop=zdrop, w0=w0,
            interpret=interpret).T
    matj = jnp.asarray(np.array(mat, np.int32).reshape(5, 5))

    def rnd(tl, ws):
        return _extend_core(o_del, e_del, o_ins, e_ins, zdrop, matj, ws,
                            qt, ql, tt, tl, h0s).T            # (P, 6)

    out0 = rnd(rlen, ws0)
    accept0 = (out0[:, 0] == prev) | \
        (out0[:, 5] < ((w0 >> 1) + (w0 >> 2)))
    out1 = rnd(jnp.where(accept0, 0, rlen), ws1)
    res = jnp.where(accept0[:, None], out0, out1)
    return jnp.concatenate(
        [res, jnp.where(accept0, 0, 1).astype(i32)[:, None],
         jnp.zeros((res.shape[0], 1), i32)], axis=1)


bsw_meta_dual = jax.jit(_meta_dual_core, static_argnames=(
    "mat", "Q", "T", "L", "l_pac", "o_del", "e_del", "o_ins", "e_ins",
    "zdrop", "w0", "kernel", "interpret", "wide_r0"))


def _bucket(x: int, lo: int) -> int:
    """Next power-of-two-ish size >= x, to bound the jit-cache key set."""
    b = lo
    while b < x:
        b <<= 1
    return b


def _q_classes(qlens: np.ndarray, lo: int = 128):
    """Partition pair indices by the power-of-two bucket of their query
    length (the analogue of the reference's 8/16-bit class split,
    comp_seed.cpp:1550-1560): the DP's per-row cost scales with the
    static state width Q, so short-query pairs must not pay a long
    pair's tile width.  Yields (bucket, indices) pairs."""
    n = len(qlens)
    buck = np.full(n, lo, np.int32)
    b = lo
    while (qlens > b).any():
        b <<= 1
        buck[qlens > b >> 1] = b
    for bv in np.unique(buck):
        yield int(bv), np.nonzero(buck == bv)[0]


def _pack_rows(buf: np.ndarray, off: np.ndarray, P: int, W: int) -> tuple:
    """Scatter flat concatenated segments into a padded (P, W) matrix."""
    n = len(off) - 1
    lens = (off[1:] - off[:-1]).astype(np.int64)
    out = np.full((P, W), 4, dtype=np.uint8)
    if len(buf):
        rows = np.repeat(np.arange(n), lens)
        cols = np.arange(len(buf)) - np.repeat(off[:-1], lens)
        out[rows, cols] = buf
    return out, lens.astype(np.int32)


def pack_dual_meta(qmeta, rmeta, h0, prev, qlens, w, max_sc, pen_clip, opt,
                   slots, n_slots):
    """The (n_slots, 12) int32 pair table of _meta_dual_core, pairs at
    rows ``slots``; pad rows get h0 = 1 and accept at round 0."""
    meta = np.zeros((n_slots, 12), np.int32)
    meta[:, 7] = 1
    meta[:, 8] = -2
    meta[slots, 0:4] = qmeta
    r0 = rmeta[:, 0]
    meta[slots, 4] = (r0 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    meta[slots, 5] = (r0 >> 32).astype(np.int32)
    meta[slots, 6] = rmeta[:, 1]
    meta[slots, 7] = h0
    meta[slots, 8] = prev
    for col, band in ((9, w), (10, 2 * w)):
        meta[slots, col] = clamp_band(qlens, band, max_sc, pen_clip,
                                      opt.o_del, opt.e_del, opt.o_ins,
                                      opt.e_ins)
    return meta


class BswRunner:
    """Pads pair batches to bucketed static shapes and runs the DP.

    Two pair interfaces:
      * ``run_meta_dual`` (the device path, on by default on the GPU):
        ~48 B of metadata per pair cross to the device, the DP tiles are
        sliced there from the chunk read matrix and the packed reference
        (ops/tiles.py), and one program runs both band rounds.  Pairs
        are sorted by target length so each kernel block early-exits at
        its own longest target (the reference's sortPairsLen,
        mapping/comp_seed.cpp:1275-1314).
      * ``run_flat``: host-packed tiles, one band round — the route for
        a chunk whose seeding fell back to the host seeder.
    On the GPU both run the DP through the Triton kernel
    (ops/bsw_triton.py); on the CPU through the XLA program.  Off the GPU
    the kernel runs only interpreted, which tests ask for with
    ``kernel=True``.
    """

    def __init__(self, opt, mat: np.ndarray, dfi=None,
                 meta: bool | None = None, kernel: bool | None = None):
        from compseed.ops.bsw_triton import mat_key
        self.opt = opt
        self.mat = jnp.asarray(mat.reshape(5, 5).astype(np.int32))
        self.mat_key = mat_key(mat)
        self.max_sc = int(mat.max())
        self.dfi = dfi               # device index (pac) for the meta path
        self._qctx = None            # (qflat device array, L) per chunk
        self._row_map = None         # read id -> qd row (sharded layout)
        on_gpu = jax.default_backend() == "gpu"
        self.meta = on_gpu if meta is None else meta
        self.kernel = on_gpu if kernel is None else kernel
        self.interpret = not on_gpu
        # sub-phase timers for the tail's "engine" bucket: pack = host
        # numpy, call = jit dispatch (async), fetch = D2H sync (includes
        # the queued device compute)
        self.prof: dict[str, float] = {}

    def run_flat(self, qbuf: np.ndarray, qoff: np.ndarray, rbuf: np.ndarray,
                 roff: np.ndarray, h0: np.ndarray, w: int, pen_clip: int):
        """Flat-buffer interface; returns six (n,) int32 numpy arrays."""
        n = len(h0)
        if n == 0:
            z = np.zeros(0, np.int32)
            return (z,) * 6
        from compseed.ops.bsw_triton import BP
        opt = self.opt
        P = _bucket(n, BP if self.kernel else 64)
        Q = _bucket(int((qoff[1:] - qoff[:-1]).max(initial=1)), 32)
        T = _bucket(int((roff[1:] - roff[:-1]).max(initial=1)), 32)
        queries, qlens = _pack_rows(qbuf, qoff, P, Q)
        targets, tlens = _pack_rows(rbuf, roff, P, T)
        h0p = np.ones(P, dtype=np.int32)
        h0p[:n] = h0
        qlp = np.zeros(P, np.int32)
        qlp[:n] = qlens
        tlp = np.zeros(P, np.int32)
        tlp[:n] = tlens
        if self.kernel:
            return self._flat_kernel(queries, qlp, targets, tlp, h0p, w,
                                     pen_clip, n)
        out = np.asarray(bsw_extend(
            opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
            opt.zdrop, pen_clip, self.max_sc, self.mat,
            jnp.int32(w), jnp.asarray(queries),
            jnp.asarray(qlp), jnp.asarray(targets),
            jnp.asarray(tlp), jnp.asarray(h0p)))
        return tuple(out[j, :n].astype(np.int32) for j in range(6))

    def _flat_kernel(self, queries, qlens, targets, tlens, h0, w: int,
                     pen_clip: int, n: int):
        """One band round through the kernel: a huge acceptance
        threshold (w0) accepts every pair at round 0."""
        from compseed.ops.bsw_triton import bsw_dual_kernel
        opt = self.opt
        ws = clamp_band(qlens, w, self.max_sc, pen_clip, opt.o_del,
                        opt.e_del, opt.o_ins, opt.e_ins)
        z = np.zeros_like(qlens)
        meta = np.stack([qlens, tlens, h0, z - 2, ws, ws, z, z])
        out = np.asarray(bsw_dual_kernel(
            jnp.asarray(queries.T.astype(np.int8)),
            jnp.asarray(targets.T.astype(np.int8)), jnp.asarray(meta),
            mat=self.mat_key, o_del=opt.o_del, e_del=opt.e_del,
            o_ins=opt.o_ins, e_ins=opt.e_ins, zdrop=opt.zdrop, w0=1 << 24,
            interpret=self.interpret))
        return tuple(out[j, :n].astype(np.int32) for j in range(6))

    def set_query_context(self, qd, L: int = 0, row_map=None) -> None:
        """Per-chunk device read matrix for metadata-only pair transfer;
        call with None to clear (e.g. a chunk that fell back to the
        legacy seeder has no device read matrix).  ``row_map`` maps a
        read id to its row in qd when the layout is not row==read id
        (the sharded seeder packs reads shard-major)."""
        if qd is None:
            self._qctx = None
            self._row_map = None
            return
        self._qctx = (qd.reshape(-1).astype(jnp.int8), L)
        self._row_map = row_map

    @property
    def supports_meta(self) -> bool:
        return (self.meta and self.dfi is not None and
                self._qctx is not None)

    def run_meta_dual(self, qmeta: np.ndarray, rmeta: np.ndarray,
                      h0: np.ndarray, prev: np.ndarray, w: int,
                      pen_clip: int):
        """Fused band-retry interface: ONE packed H2D buffer, one device
        program running both band rounds + acceptance (bsw_meta_dual),
        one D2H fetch.  Returns seven (n,) int32 arrays: the six DP
        results of the accepted round + the accepted round index."""
        import time as _time
        from compseed.ops.bsw_triton import BP
        opt = self.opt
        n = len(h0)
        if n == 0:
            z = np.zeros(0, np.int32)
            return (z,) * 7
        t0 = _time.perf_counter()
        qflat, L = self._qctx
        if self._row_map is not None:
            qmeta = qmeta.copy()
            qmeta[:, 0] = self._row_map[qmeta[:, 0]]
        qlens = qmeta[:, 2].astype(np.int32)
        tlens = rmeta[:, 1].astype(np.int32)
        wide = np.dtype(self.dfi.dtype) == np.int64
        res = np.zeros((n, 7), np.int32)
        for Q, cls in _q_classes(qlens):
            m = len(cls)
            order = cls[np.argsort(tlens[cls], kind="stable")]
            P = _bucket(m, BP)
            T = _bucket(int(tlens[order].max(initial=1)), 128)
            meta = pack_dual_meta(qmeta[order], rmeta[order], h0[order],
                                  prev[order], qlens[order], w, self.max_sc,
                                  pen_clip, opt, np.arange(m), P)
            t1 = _time.perf_counter()
            out_dev = bsw_meta_dual(
                self.mat_key, qflat, self.dfi.pac_words, jnp.asarray(meta),
                Q=Q, T=T, L=L, l_pac=self.dfi.l_pac,
                o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                e_ins=opt.e_ins, zdrop=opt.zdrop, w0=int(w),
                kernel=self.kernel,
                interpret=self.interpret, wide_r0=wide)
            t2 = _time.perf_counter()
            out = np.asarray(out_dev)
            t3 = _time.perf_counter()
            res[order] = out[:m, :7]
            for k, dt in (("engine_pack", t1 - t0), ("engine_call", t2 - t1),
                          ("engine_fetch", t3 - t2)):
                self.prof[k] = self.prof.get(k, 0.0) + dt
            t0 = _time.perf_counter()
        # each result crosses a raw ctypes pointer: must be C-contiguous
        return tuple(np.ascontiguousarray(res[:, j]) for j in range(7))

    def __call__(self, pairs, w: int, pen_clip: int):
        if not pairs:
            return []
        qoff = np.zeros(len(pairs) + 1, np.int64)
        roff = np.zeros(len(pairs) + 1, np.int64)
        np.cumsum([len(sp.qs) for sp in pairs], out=qoff[1:])
        np.cumsum([len(sp.rs) for sp in pairs], out=roff[1:])
        qbuf = np.concatenate([sp.qs for sp in pairs]) if qoff[-1] else \
            np.zeros(0, np.uint8)
        rbuf = np.concatenate([sp.rs for sp in pairs]) if roff[-1] else \
            np.zeros(0, np.uint8)
        h0 = np.array([sp.h0 for sp in pairs], np.int32)
        arrs = self.run_flat(qbuf, qoff, rbuf, roff, h0, w, pen_clip)
        return [tuple(int(a[i]) for a in arrs) for i in range(len(pairs))]

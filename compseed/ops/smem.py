"""Batched SMEM seeding on device.

The reference walks a per-thread pointer trie (SST, mapping/SST.h) to
memoize FM-index extensions across a batch of compressor-reordered reads.
On the device the same three seeding rounds (mapping/comp_seed.cpp:2262-2301)
become fixed-shape scan programs vectorized over read lanes:

  round 1  collect_mem (comp_seed.cpp:67-139 == bwt_smem1a, bwt.c:289-351):
           forward sweep collecting LEP intervals, then a backward-shrink
           loop over the LEP frontier.  The frontier is kept compacted in
           ascending-interval-size order, which makes the reference's
           sequential list logic (first-failure emission, equal-size
           dedup) expressible as masked cummax/cumsum passes.
  round 2  re-seeding from SMEM midpoints with min_hits = occ + 1.
  round 3  greedy forward pass (tem_forward_sst, comp_seed.cpp:141-160)
           fused into ONE left-to-right scan per read (the reference
           restarts a scan after each hit; the restart state is carried
           in-lane instead).

Fixed caps (LEP frontier, SMEMs per call) are enforced with overflow
flags; overflowing reads fall back to the scalar oracle so results are
always exact.  All rounds share occ gathers through ops.fm.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from compseed.cpu import fm_oracle as fo
from compseed.ops import fm as dfm
from compseed.ops.device_index import DeviceFMIndex, to_device
from compseed.pipeline.seeding import SeedingStats
from compseed.pipeline.types import Seed

MLEP = 32    # LEP frontier cap (pushes need distinct interval sizes)
MMEM = 32    # SMEMs per collect call
MMEM3 = 32   # round-3 seeds per read


def _set_intv(fm: DeviceFMIndex, c):
    dt = fm.dtype
    L2 = fm.L2
    c = c.astype(jnp.int32)
    return jnp.stack([L2[c] + 1, L2[3 - c] + 1, L2[c + 1] - L2[c]]).astype(dt)


def _collect_one(fm: DeviceFMIndex, L: int, q, pivot, min_hits, active):
    """Per-read collect_mem; vmapped over the batch by the caller.

    Returns (mems (MMEM,5), n_mems, ret_pivot, overflow).
    mems rows: k, l, s, beg, end — in emission order (descending beg).
    """
    dt = fm.dtype
    i32 = jnp.int32
    pivot = pivot.astype(i32)
    min_hits = jnp.maximum(min_hits.astype(dt), 1)

    first_base = q[jnp.clip(pivot, 0, L - 1)].astype(i32)
    bad_start = (first_base > 3) | ~active

    # ---------------- forward sweep (comp_seed.cpp:76-97)
    ik0 = _set_intv(fm, jnp.clip(first_base, 0, 3))

    fwd_init = dict(
        ik=ik0, end=pivot + 1, stopped=bad_start,
        ret=jnp.where(bad_start, pivot + 1, jnp.asarray(L, i32)),
        lep=jnp.zeros((MLEP, 3), dt), lep_end=jnp.zeros(MLEP, i32),
        cnt=jnp.asarray(0, i32), ovf=jnp.asarray(False),
        next_c=jnp.asarray(-1, i32),  # pending child when stopped at shrink
    )

    def fwd_step(t, st):
        i = pivot + 1 + t
        act = (~st["stopped"]) & (i < L)
        base = q[jnp.clip(i, 0, L - 1)].astype(i32)
        amb = base > 3
        c = 3 - jnp.clip(base, 0, 3)
        ok = dfm.extend_batch(fm, st["ik"], is_back=False)   # (4, 3)
        okc = ok[c]
        changed = okc[2] != st["ik"][2]
        too_small = okc[2] < min_hits
        push = act & (amb | changed)
        stop_amb = act & amb
        stop_small = act & ~amb & changed & too_small
        reach = act & ~amb & ~stop_small

        slot = jnp.minimum(st["cnt"], MLEP - 1)
        lep = jnp.where(push,
                        st["lep"].at[slot].set(st["ik"]), st["lep"])
        lep_end = jnp.where(push,
                            st["lep_end"].at[slot].set(st["end"]),
                            st["lep_end"])
        ovf = st["ovf"] | (push & (st["cnt"] >= MLEP))
        cnt = st["cnt"] + (push & (st["cnt"] < MLEP)).astype(i32)

        ik = jnp.where(reach, okc.astype(dt), st["ik"])
        end = jnp.where(reach, i + 1, st["end"])
        ret = jnp.where(stop_amb, i + 1,
                        jnp.where(stop_small, i, st["ret"]))
        stopped = st["stopped"] | stop_amb | stop_small
        return dict(ik=ik, end=end, stopped=stopped, ret=ret, lep=lep,
                    lep_end=lep_end, cnt=cnt, ovf=ovf, next_c=st["next_c"])

    fwd_init["t"] = jnp.asarray(0, i32)

    def fwd_cond(st):
        return (~st["stopped"]) & (pivot + 1 + st["t"] < L)

    def fwd_body(st):
        t = st.pop("t")
        st = fwd_step(t, st)
        st["t"] = t + 1
        return st

    st = jax.lax.while_loop(fwd_cond, fwd_body, fwd_init)
    st.pop("t")

    # final push when the sweep reached the read end (comp_seed.cpp:97)
    reached_end = (~st["stopped"]) & ~bad_start
    slot = jnp.minimum(st["cnt"], MLEP - 1)
    lep = jnp.where(reached_end, st["lep"].at[slot].set(st["ik"]), st["lep"])
    lep_end = jnp.where(reached_end,
                        st["lep_end"].at[slot].set(st["end"]), st["lep_end"])
    ovf = st["ovf"] | (reached_end & (st["cnt"] >= MLEP))
    cnt = st["cnt"] + (reached_end & (st["cnt"] < MLEP)).astype(jnp.int32)
    ret = st["ret"]

    # reverse the LEP list so ascending interval sizes sit at 0..cnt-1
    idx = jnp.arange(MLEP, dtype=jnp.int32)
    src = jnp.clip(cnt - 1 - idx, 0, MLEP - 1)
    cur = lep[src]                       # (MLEP, 3)
    cur_end = lep_end[src]
    valid0 = idx < cnt

    # pivot == 0 fast path: only the longest match is an SMEM
    # (comp_seed.cpp:98-101)
    fast = (pivot == 0) & ~bad_start

    mems = jnp.zeros((MMEM, 5), dt)
    fast_row = jnp.concatenate([cur[0], jnp.asarray([0], dt),
                                cur_end[0].astype(dt)[None]])
    mems_fast = mems.at[0].set(fast_row)

    # ---------------- backward shrink (comp_seed.cpp:105-137)
    bwd_init = dict(
        cur=cur, cur_end=cur_end, n=jnp.where(valid0.any(), cnt, 0),
        mems=mems, n_mems=jnp.asarray(0, jnp.int32),
        last_beg=jnp.asarray(L + 2, jnp.int32),
        done=bad_start | fast, ovf=jnp.asarray(False),
    )

    def bwd_step(u, st):
        i = pivot - 1 - u
        act = (~st["done"]) & (i >= -1)
        base = jnp.where(i >= 0, q[jnp.clip(i, 0, L - 1)].astype(jnp.int32), 4)
        cvalid = base < 4
        c = jnp.clip(base, 0, 3)
        valid = idx < st["n"]
        ok = dfm.extend_batch(fm, st["cur"], is_back=True)  # (MLEP, 4, 3)
        okc = ok[:, c, :]                                    # (MLEP, 3)
        survive = valid & cvalid & (okc[:, 2] >= min_hits)
        # first slot fails -> emit its (old) interval as an SMEM
        fail0 = (st["n"] > 0) & ~(cvalid & (okc[0, 2] >= min_hits))
        emit = act & fail0 & ((st["n_mems"] == 0) |
                              (i + 1 < st["last_beg"]))
        mrow = jnp.concatenate([st["cur"][0],
                                jnp.asarray([i + 1], dt),
                                st["cur_end"][0].astype(dt)[None]])
        mslot = jnp.minimum(st["n_mems"], MMEM - 1)
        mems = jnp.where(emit, st["mems"].at[mslot].set(mrow), st["mems"])
        ovf = st["ovf"] | (emit & (st["n_mems"] >= MMEM))
        n_mems = st["n_mems"] + (emit & (st["n_mems"] < MMEM)).astype(jnp.int32)
        last_beg = jnp.where(emit, i + 1, st["last_beg"])

        # dedup equal sizes (keep first), sizes are non-decreasing
        s_ok = okc[:, 2]
        masked = jnp.where(survive, s_ok, -1)
        run = jax.lax.associative_scan(jnp.maximum, masked)
        excl = jnp.concatenate([jnp.asarray([-1], dt), run[:-1]])
        keep = survive & (masked > excl)
        pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
        dest = jnp.where(keep, pos, MLEP)
        new_cur = jnp.zeros_like(st["cur"]).at[dest].set(okc, mode="drop")
        new_end = jnp.zeros_like(st["cur_end"]).at[dest].set(
            st["cur_end"], mode="drop")
        new_n = keep.sum().astype(jnp.int32)

        done = st["done"] | (act & (new_n == 0)) | (~act & ~st["done"])
        cur_out = jnp.where(act, new_cur, st["cur"])
        end_out = jnp.where(act, new_end, st["cur_end"])
        n_out = jnp.where(act, new_n, st["n"])
        return dict(cur=cur_out, cur_end=end_out, n=n_out, mems=mems,
                    n_mems=n_mems, last_beg=last_beg, done=done, ovf=ovf)

    bwd_init["u"] = jnp.asarray(0, i32)

    def bwd_cond(st):
        return (~st["done"]) & (st["u"] <= pivot)

    def bwd_body(st):
        u = st.pop("u")
        st = bwd_step(u, st)
        st["u"] = u + 1
        return st

    bst = jax.lax.while_loop(bwd_cond, bwd_body, bwd_init)

    mems_out = jnp.where(fast, mems_fast, bst["mems"])
    n_out = jnp.where(fast, 1, bst["n_mems"])
    n_out = jnp.where(bad_start, 0, n_out)
    overflow = ovf | bst["ovf"]
    return jnp.concatenate([
        mems_out.reshape(-1).astype(dt),
        jnp.stack([n_out.astype(dt), ret.astype(dt),
                   overflow.astype(dt)])])


def _seed_strategy_one(fm: DeviceFMIndex, L: int, min_len: int,
                       max_intv: int, q, active):
    """Fused round-3 pass for one read (vmapped).

    Returns (mems (MMEM3,5), n, overflow); rows k,l,s,beg,end.
    The reference restarts bwt_seed_strategy1 after every hit/N
    (comp_seed.cpp:2290-2298); one scan carries the restart in-lane.
    """
    dt = fm.dtype
    i32 = jnp.int32

    init = dict(
        s0=jnp.asarray(0, i32),
        ik=jnp.zeros(3, dt),
        mems=jnp.zeros((MMEM3, 5), dt),
        n=jnp.asarray(0, i32),
        ovf=jnp.asarray(False),
    )

    def step(i, st):
        base = q[i].astype(i32)
        amb = base > 3
        at_start = i == st["s0"]
        inside = i > st["s0"]

        # restart cases
        ik_new = _set_intv(fm, jnp.clip(base, 0, 3))
        c = 3 - jnp.clip(base, 0, 3)
        ok = dfm.extend_batch(fm, st["ik"], is_back=False)
        okc = ok[c]
        hit = inside & ~amb & (okc[2] < max_intv) & \
            ((i - st["s0"]) >= min_len) & active
        mrow = jnp.concatenate([okc.astype(dt),
                                st["s0"].astype(dt)[None],
                                jnp.asarray(i + 1, dt)[None]])
        slot = jnp.minimum(st["n"], MMEM3 - 1)
        mems = jnp.where(hit, st["mems"].at[slot].set(mrow), st["mems"])
        ovf = st["ovf"] | (hit & (st["n"] >= MMEM3))
        n = st["n"] + (hit & (st["n"] < MMEM3)).astype(i32)

        s0 = jnp.where(amb | hit, i + 1, st["s0"])
        ik = jnp.where(at_start & ~amb, ik_new,
                       jnp.where(inside & ~amb & ~hit, okc.astype(dt),
                                 st["ik"]))
        return dict(s0=s0, ik=ik, mems=mems, n=n, ovf=ovf)

    st = jax.lax.fori_loop(0, L, step, init)
    return jnp.concatenate([
        st["mems"].reshape(-1).astype(dt),
        jnp.stack([st["n"].astype(dt), st["ovf"].astype(dt)])])


class BatchSeeder:
    """Device-backed seeder with the pipeline.align seeder interface."""

    def __init__(self, opt, fm, dfi: DeviceFMIndex | None = None):
        self.opt = opt
        self.fm = fm
        self.dfi = dfi if dfi is not None else to_device(fm)
        self._collect_cache = {}
        self._round3_cache = {}
        self._sa_cache = {}
        # wall-time per phase (the reference's display_profile equivalent,
        # main.cpp:203-214): r1 entries are (n_lanes, seconds)
        self.prof = {"r1": [], "r2": 0.0, "r3": 0.0, "sal": 0.0,
                     "post": 0.0}

    # The device index is a CALL-TIME argument to every jitted program
    # (bound via partial at call sites below) so its multi-GB arrays are
    # runtime operands, not captured constants — at hg19 scale each
    # embedded copy costs 2.3+ GB of executable memory (see seeder2.py).
    def _collect_fn(self, L: int):
        if L not in self._collect_cache:
            f = jax.vmap(lambda fm_, q, p, h, a: _collect_one(
                fm_, L, q, p, h, a), in_axes=(None, 0, 0, 0, 0))
            self._collect_cache[L] = jax.jit(f)
        return partial(self._collect_cache[L], self.dfi)

    def _round3_fn(self, L: int):
        key = (L, self.opt.min_seed_len, int(self.opt.max_mem_intv))
        if key not in self._round3_cache:
            ml, mi = self.opt.min_seed_len, int(self.opt.max_mem_intv)
            f = jax.vmap(lambda fm_, q, a: _seed_strategy_one(
                fm_, L, ml, mi, q, a), in_axes=(None, 0, 0))
            self._round3_cache[key] = jax.jit(f)
        return partial(self._round3_cache[key], self.dfi)

    def _sa_fn(self):
        if "f" not in self._sa_cache:
            self._sa_cache["f"] = jax.jit(dfm.sa_batch)
        return partial(self._sa_cache["f"], self.dfi)

    SEED_BLOCK = 8192

    # ------------------------------------------------------------------
    def run_flat(self, queries: list[np.ndarray],
                 stats: SeedingStats | None = None):
        """Vectorized interface: returns (lrep, sflat, soff) where lrep
        is the per-read repetitive-coverage length (the only chaining
        input derived from matches, comp_seed.cpp:271-281) and sflat
        rows are (rbeg, qbeg, len) — the native tail's input format."""
        from compseed.pipeline.chain import l_rep_flat
        outs = [self._run(queries[s: s + self.SEED_BLOCK], stats)
                for s in range(0, len(queries), self.SEED_BLOCK)]
        lrep = np.concatenate(
            [l_rep_flat(o[0], o[1], self.opt.max_occ) for o in outs])
        if len(outs) == 1:
            return lrep, outs[0][2], outs[0][3]
        sflat = np.concatenate([o[2] for o in outs])
        soff = np.concatenate(
            [outs[0][3]] + [o[3][1:] + off for o, off in
                            zip(outs[1:], np.cumsum(
                                [o[3][-1] for o in outs[:-1]]))])
        return lrep, sflat, soff

    def __call__(self, fm, opt, queries: list[np.ndarray],
                 stats: SeedingStats | None = None):
        """Legacy per-read interface for the Python tail and tests."""
        out = []
        for s in range(0, len(queries), self.SEED_BLOCK):
            block = queries[s: s + self.SEED_BLOCK]
            mflat, moff, sflat, soff = self._run(block, stats)
            for r in range(len(block)):
                ms = [tuple(int(x) for x in row)
                      for row in self._mrows[moff[r]: moff[r + 1]]]
                seeds = [Seed(rbeg=int(rb), qbeg=int(qb), len=int(ln),
                              score=int(ln))
                         for rb, qb, ln in sflat[soff[r]: soff[r + 1]]]
                out.append((ms, seeds))
        return out

    def _run(self, queries: list[np.ndarray],
             stats: SeedingStats | None = None):
        opt = self.opt
        R = len(queries)
        L = _round_up(max(len(q) for q in queries), 32)
        qarr = np.full((R, L), 4, dtype=np.uint8)
        lens = np.zeros(R, dtype=np.int32)
        for i, q in enumerate(queries):
            qarr[i, :len(q)] = q
            lens[i] = len(q)
        # NB: padding with 4 (ambiguous) naturally terminates sweeps at the
        # true read end; ret_pivot is clamped to the true length below.
        qdev = jnp.asarray(qarr)
        collect = self._collect_fn(L)

        chunks: list[np.ndarray] = []  # (M, 6): read, k, l, s, beg, end

        def add_rows(read_ids, mems, counts, min_len, max_end=None):
            valid = np.arange(mems.shape[1])[None, :] < counts[:, None]
            lane, slot = np.nonzero(valid)
            if len(lane) == 0:
                return
            rows = mems[lane, slot].astype(np.int64)      # k,l,s,beg,end
            rids = read_ids[lane].astype(np.int64)
            keep = (rows[:, 4] - rows[:, 3]) >= min_len
            keep &= rows[:, 2] > 0
            if max_end is not None:
                keep &= rows[:, 4] <= max_end[lane]
            rows = rows[keep]
            rids = rids[keep]
            chunks.append(np.concatenate([rids[:, None], rows], axis=1))

        def add_tuples(r, ms, min_len):
            rows = np.array([(r, k, l, s, beg, end)
                             for (k, l, s, beg, end) in ms
                             if end - beg >= min_len and s > 0],
                            dtype=np.int64).reshape(-1, 6)
            if len(rows):
                chunks.append(rows)

        def run_collect(q_rows, piv, mh):
            n_lanes = len(piv)
            P = 64
            while P < n_lanes:
                P <<= 1
            qp = np.full((P, L), 4, dtype=np.uint8)
            qp[:n_lanes] = q_rows
            pp = np.zeros(P, np.int32)
            pp[:n_lanes] = piv
            hh = np.ones(P, np.int32)
            hh[:n_lanes] = mh
            aa = np.zeros(P, bool)
            aa[:n_lanes] = True
            packed = np.asarray(collect(jnp.asarray(qp), jnp.asarray(pp),
                                        jnp.asarray(hh), jnp.asarray(aa)))
            packed = packed[:n_lanes]
            mems = packed[:, : MMEM * 5].reshape(n_lanes, MMEM, 5)
            return (mems, packed[:, MMEM * 5].astype(np.int64),
                    packed[:, MMEM * 5 + 1].astype(np.int64),
                    packed[:, MMEM * 5 + 2] != 0)

        import time as _time

        # -------- round 1: repeated collect; later iterations compact to
        # the (rapidly shrinking) set of still-active reads
        pivots = np.zeros(R, dtype=np.int32)
        while True:
            idxs = np.nonzero(pivots < lens)[0]
            if len(idxs) == 0:
                break
            _t0 = _time.time()
            mems, n, ret, ovf = run_collect(
                qarr[idxs], pivots[idxs], np.ones(len(idxs), np.int32))
            self.prof["r1"].append((len(idxs), _time.time() - _t0))
            ovf_lanes = np.nonzero(ovf)[0]
            n = n.copy()
            for t in ovf_lanes:  # exactness fallback per overflowing read
                r = idxs[t]
                ms, rp = fo.collect_mem(self.fm, queries[r],
                                        int(pivots[r]), 1)
                add_tuples(r, ms, opt.min_seed_len)
                n[t] = 0
                ret[t] = rp
            add_rows(idxs, mems, n, opt.min_seed_len)
            pivots[idxs] = np.minimum(ret, lens[idxs])
            bad = pivots[idxs] <= 0
            if bad.any():
                pivots[idxs[bad]] = lens[idxs[bad]]  # safety: progress

        r1 = np.concatenate(chunks) if chunks else np.zeros((0, 6), np.int64)

        # -------- round 2: re-seed long low-occ matches from midpoints
        split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
        sel = ((r1[:, 5] - r1[:, 4] >= split_len) &
               (r1[:, 3] <= opt.split_width))
        if sel.any():
            _t0 = _time.time()
            rr = r1[sel]
            rids2 = rr[:, 0].astype(np.int64)
            p2 = ((rr[:, 4] + rr[:, 5]) // 2).astype(np.int32)
            h2 = (rr[:, 3] + 1).astype(np.int32)
            mems, n, _, ovf = run_collect(qarr[rids2], p2, h2)
            ovf_lanes = np.nonzero(ovf)[0]
            n = n.copy()
            for t in ovf_lanes:
                r = int(rids2[t])
                ms, _ = fo.collect_mem(self.fm, queries[r], int(p2[t]),
                                       int(h2[t]))
                add_tuples(r, ms, opt.min_seed_len)
                n[t] = 0
            add_rows(rids2, mems, n, opt.min_seed_len)
            self.prof["r2"] += _time.time() - _t0

        # -------- round 3: greedy forward seeding
        if opt.max_mem_intv > 0:
            _t0 = _time.time()
            packed = np.asarray(self._round3_fn(L)(
                qdev, jnp.asarray(np.ones(R, bool))))
            mems = packed[:, : MMEM3 * 5].reshape(R, MMEM3, 5)
            n = packed[:, MMEM3 * 5].astype(np.int64).copy()
            ovf = packed[:, MMEM3 * 5 + 1] != 0
            for r in np.nonzero(ovf)[0]:
                j = 0
                ms = []
                while j < lens[r]:
                    if queries[r][j] < 4:
                        mem, j = fo.seed_strategy1(
                            self.fm, queries[r], j, opt.min_seed_len,
                            opt.max_mem_intv)
                        if mem is not None and mem[2] > 0:
                            ms.append(mem)
                    else:
                        j += 1
                add_tuples(int(r), ms, 0)
                n[r] = 0
            add_rows(np.arange(R), mems, n, 0, max_end=lens)
            self.prof["r3"] += _time.time() - _t0

        _t0 = _time.time()
        allm = np.concatenate(chunks) if chunks else np.zeros((0, 6),
                                                              np.int64)
        order = np.lexsort((allm[:, 5], allm[:, 4], allm[:, 0]))
        allm = allm[order]
        moff = np.zeros(R + 1, dtype=np.int64)
        np.cumsum(np.bincount(allm[:, 0], minlength=R), out=moff[1:])
        self._mrows = allm[:, [1, 2, 3, 4, 5]]  # (k, l, s, beg, end)

        # -------- seed sampling (comp_seed.cpp:2313-2324), vectorized
        occ = allm[:, 3]
        step = np.where(occ > opt.max_occ,
                        occ // np.int64(opt.max_occ), 1)
        cnt = np.minimum(-(-occ // step), opt.max_occ).astype(np.int64)
        total = int(cnt.sum())
        midx = np.repeat(np.arange(len(allm)), cnt)
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
        locs = allm[midx, 1] + within * step[midx]
        sflat = np.empty((total, 3), dtype=np.int64)
        sflat[:, 1] = allm[midx, 4]                      # qbeg
        sflat[:, 2] = allm[midx, 5] - allm[midx, 4]      # len
        soff = np.zeros(R + 1, dtype=np.int64)
        np.cumsum(np.bincount(allm[midx, 0], minlength=R), out=soff[1:])

        self.prof["post"] += _time.time() - _t0

        # -------- merged SAL on device (comp_seed.cpp:2306-2347)
        _t0 = _time.time()
        if total:
            uniq = np.unique(locs)
            P = 256
            while P < len(uniq):
                P <<= 1
            padded = np.zeros(P, dtype=np.int64)
            padded[: len(uniq)] = uniq
            vals = np.asarray(self._sa_fn()(jnp.asarray(padded)))[:len(uniq)]
            sflat[:, 0] = vals[np.searchsorted(uniq, locs)]
            if stats is not None:
                stats.sal_queries += total
                stats.sal_calls += len(uniq)
        self.prof["sal"] += _time.time() - _t0
        mflat = allm[:, [4, 5, 3]].copy()  # (beg, end, occ)
        return mflat, moff, sflat, soff


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m

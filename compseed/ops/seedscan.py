"""Device-resident compressive seeding (v2): dense worklists, no lockstep
padding, device-side SMEM reconstruction.

The reference's per-read recursion (collect_mem_with_sst,
mapping/comp_seed.cpp:67-139) serializes a forward LEP sweep and a
backward-shrink loop over a pointer trie.  The device decomposition here:

  1. ``scan_collect`` — one forward pass per read (vmapped, one
     bwt_extend per step) that walks pivots in sequence and records every
     LEP interval into a per-read buffer.  Because round-1 pivot advance
     depends only on the forward sweep (ret = forward stop position,
     comp_seed.cpp:92-97), all pivots of a read are discovered in a
     single scan.
  2. Backward shrink is re-derived as INDEPENDENT single-interval walks:
     within one pivot's LEP list (ascending interval size), intervals are
     nested, so survival is monotone — if entry j survives a step, j+1
     does too.  Hence each LEP can walk backward alone (one bwt_extend
     per step), and the reference's emission rule reduces to: emit entry
     j iff its death position is strictly below all earlier deaths, with
     beg = death+1 (equal deaths reproduce the first-slot-only emission
     and the equal-size dedup of comp_seed.cpp:114-137 exactly; the
     pivot==0 fast path falls out as death == -1 on every entry).
     Walks run as a dense flat worklist over the whole chunk with staged
     compaction (argsort live lanes to the front, slice, continue), so
     short walks — the vast majority — cost no lockstep padding.
  3. Reconstruction (emit flags, round-2 task extraction) is neighbor
     logic over the pool in (read, push-order) layout — pure VPU ops.

Everything stays on device; the host only receives the final compact
match/seed arrays.  Overflow of any static cap raises a flag and the
caller falls back to the exact host oracle for the affected reads.
"""

from __future__ import annotations

from functools import partial

import os

import jax
import jax.numpy as jnp
import numpy as np

from compseed.ops import fm as dfm
from compseed.ops.device_index import DeviceFMIndex

CAPL = 96       # LEP rows per read (round 1, all pivots)
CAPL2 = 32      # LEP rows per round-2 task


def _set_intv(fm: DeviceFMIndex, c):
    dt = fm.dtype
    L2 = fm.L2
    c = c.astype(jnp.int32)
    return jnp.stack([L2[c] + 1, L2[3 - c] + 1, L2[c + 1] - L2[c]]).astype(dt)


# ----------------------------------------------------------------------
# forward collect scan
# ----------------------------------------------------------------------

def _scan_one(fm: DeviceFMIndex, L: int, capl: int, advance: bool,
              q, rlen, pivot0, min_hits, active):
    """One read's forward pass; returns (lep (capl,5), cnt, ovf).

    lep rows: k, l, s, end, pivot.  Push order (descending interval
    size within each pivot group).  With ``advance`` the scan continues
    to the next pivot after each stop (round 1); otherwise it finishes
    after the first collect (round 2 task).
    """
    dt = fm.dtype
    i32 = jnp.int32
    rlen = rlen.astype(i32)
    min_hits = jnp.maximum(min_hits.astype(dt), 1)

    st = dict(
        pivot=pivot0.astype(i32),
        i=jnp.asarray(0, i32),
        phase=jnp.asarray(0, i32),           # 0 = start pivot, 1 = sweep
        ik=jnp.zeros(3, dt),
        end=jnp.asarray(0, i32),
        lep=jnp.zeros((capl, 5), dt),
        cnt=jnp.asarray(0, i32),
        ovf=jnp.asarray(False),
        done=~active,
    )

    def body(st):
        # ---- phase 0: start a new pivot
        start = (st["phase"] == 0) & ~st["done"]
        pv = st["pivot"]
        done = st["done"] | (start & (pv >= rlen))
        do_start = start & (pv < rlen)
        base0 = q[jnp.clip(pv, 0, L - 1)].astype(i32)
        bad = base0 > 3
        pivot = jnp.where(do_start & bad, pv + 1, pv)
        started = do_start & ~bad
        ik = jnp.where(started, _set_intv(fm, jnp.clip(base0, 0, 3)),
                       st["ik"])
        end = jnp.where(started, pv + 1, st["end"])
        i = jnp.where(started, pv + 1, st["i"])
        phase = jnp.where(started, 1, st["phase"])

        # ---- phase 1: one forward step (comp_seed.cpp:76-97); positions
        # past the read end behave as an ambiguous base, which pushes and
        # stops exactly like the i == len exit of the reference
        sweep = (phase == 1) & ~done
        base = jnp.where(i < rlen, q[jnp.clip(i, 0, L - 1)].astype(i32), 4)
        amb = base > 3
        c = 3 - jnp.clip(base, 0, 3)
        ok = dfm.extend_batch(fm, ik, is_back=False)       # (4, 3)
        okc = ok[c]
        changed = okc[2] != ik[2]
        small = okc[2] < min_hits
        push = sweep & (amb | changed)
        stop = sweep & (amb | (changed & small))
        cont = sweep & ~stop & ~amb

        slot = jnp.minimum(st["cnt"], capl - 1)
        row = jnp.concatenate([ik, jnp.stack([
            end.astype(dt), pivot.astype(dt)])])
        lep = jnp.where(push, st["lep"].at[slot].set(row), st["lep"])
        ovf = st["ovf"] | (push & (st["cnt"] >= capl))
        cnt = st["cnt"] + (push & (st["cnt"] < capl)).astype(i32)

        npv = jnp.where(amb, i + 1, i)
        if advance:
            pivot = jnp.where(stop, npv, pivot)
            phase = jnp.where(stop, 0, phase)
        else:
            done = done | stop
        ik = jnp.where(cont, okc.astype(dt), ik)
        end = jnp.where(cont, i + 1, end)
        i = jnp.where(cont, i + 1, i)
        return dict(pivot=pivot, i=i, phase=phase, ik=ik, end=end, lep=lep,
                    cnt=cnt, ovf=ovf, done=done)

    # segmented while (see walk_stage): the all-done check only every
    # 8 fully-masked steps
    def seg(st):
        return jax.lax.fori_loop(0, 8, lambda _, x: body(x), st)

    st = jax.lax.while_loop(lambda s: ~s["done"], seg, st)
    return (st["lep"].reshape(-1),
            st["cnt"].astype(dt), st["ovf"].astype(dt))


def make_scan(fm: DeviceFMIndex, L: int, capl: int, advance: bool):
    """fm here only pins the static dtype; the runner takes the index as
    a call-time argument so jitted callers treat its arrays as operands
    instead of multi-GB captured constants (hg19-scale HBM hygiene)."""
    f = jax.vmap(lambda fm_, *a: _scan_one(fm_, L, capl, advance, *a),
                 in_axes=(None, 0, 0, 0, 0, 0))

    def run(fm_, qarr, rlens, pivots, min_hits, active):
        lep, cnt, ovf = f(fm_, qarr, rlens, pivots, min_hits, active)
        R = qarr.shape[0]
        return lep.reshape(R, capl, 5), cnt, ovf

    return partial(run, fm) if fm is not None else run


# ----------------------------------------------------------------------
# backward walks (dense worklist, staged compaction)
# ----------------------------------------------------------------------

REV_W = 8             # chars per packed reverse window (= max SEG)


def packed_rev_windows(qarr):
    """rw[r, p] = 3-bit-packed codes q[p], q[p-1], ..., q[p-REV_W+1]
    (positions below 0 read as 4), flattened.  A backward walk consumes
    positions monotonically downward, so one window gather per
    REV_W-step walk segment replaces a per-step qflat char gather —
    the per-op gather floor is the unit cost of these loops."""
    R, L = qarr.shape
    ext = jnp.concatenate(
        [jnp.full((R, REV_W - 1), 4, qarr.dtype), qarr],
        axis=1).astype(jnp.uint32)
    rw = jnp.zeros((R, L), jnp.uint32)
    for j in range(REV_W):
        rw = rw | (ext[:, (REV_W - 1 - j):(REV_W - 1 - j) + L]
                   << np.uint32(3 * j))
    return rw.reshape(-1)


def walk_stage(fm: DeviceFMIndex, qflat, L: int, max_steps: int, state,
               t0=None, fit: int = 0, rwflat=None):
    """Advance every live item by backward extensions until all are
    dead, max_steps total (across stages — t0 carries in), or — when
    ``fit`` > 0 — the live count fits a ``fit``-wide continuation (the
    caller then compacts and runs a narrower twin; walks per lane are
    deterministic, so segmentation is bit-exact).

    state: dict of arrays over M lanes:
      k, l, s (dt); rid, i, death (i32); mh (dt, min_hits);
      alive (bool); slot (i32, original pool index; -1 = padding)

    With ``rwflat`` (packed_rev_windows) the consumed chars decode from
    ONE window gather per segment: a lane alive at local step t sits at
    position i0 - t (i decrements exactly while alive; dead lanes mask
    their base), so the decode is bit-exact vs the per-step gather.
    """
    dt = fm.dtype
    i32 = jnp.int32

    def body(tl, carry, rw=None, i0=None):
        t, st = carry
        alive = st["alive"]
        i = st["i"]
        if rw is None:
            base = jnp.where(
                i >= 0,
                qflat[jnp.clip(st["rid"] * L + i, 0, qflat.shape[0] - 1)]
                .astype(i32),
                4)
        else:
            dec = ((rw >> (jnp.uint32(3) * tl.astype(jnp.uint32)))
                   & jnp.uint32(7)).astype(i32)
            base = jnp.where(i >= 0, dec, 4)
        c = jnp.clip(base, 0, 3)
        ik = jnp.stack([st["k"], st["l"], st["s"]], axis=-1)      # (M, 3)
        okc = dfm.extend_sel_batch(fm, ik, c, is_back=True)       # (M, 3)
        survive = alive & (base < 4) & (okc[:, 2] >= st["mh"])
        die = alive & ~survive
        st = dict(st)
        # per-lane executed-extension count (the reference's bwt_call
        # unit, SST.h): an mh-death still performed its killing call; an
        # N/past-start death did not
        if "steps" in st:
            st["steps"] = st["steps"] + \
                (alive & (base < 4)).astype(i32)
        st["death"] = jnp.where(die, i, st["death"])
        st["alive"] = survive
        st["k"] = jnp.where(survive, okc[:, 0], st["k"])
        st["l"] = jnp.where(survive, okc[:, 1], st["l"])
        st["s"] = jnp.where(survive, okc[:, 2], st["s"])
        st["i"] = jnp.where(survive, i - 1, i)
        return t + 1, st

    # segmented loop: check the alive/fit reduction every SEG steps
    # (segmenting amortizes loop carries and condition checks).
    # The inner trip count is clamped so the walk never exceeds
    # max_steps (the old fixed-SEG version overshot).
    SEG = max(1, min(REV_W, max_steps))

    def seg_body(carry):
        t0_, st = carry
        if rwflat is None:
            def inner(tl, c):
                return body(jnp.asarray(tl, i32), c)
        else:
            i0 = st["i"]
            idx = jnp.clip(st["rid"] * L + jnp.clip(i0, 0, L - 1),
                           0, rwflat.shape[0] - 1)
            rw = rwflat[idx]
            def inner(tl, c):
                return body(jnp.asarray(tl, i32), c, rw=rw, i0=i0)
        return jax.lax.fori_loop(
            jnp.asarray(0, i32),
            jnp.minimum(jnp.asarray(SEG, i32),
                        jnp.asarray(max_steps, i32) - t0_),
            inner, (t0_, st))

    def cond(carry):
        t, st = carry
        return (t < max_steps) & \
            (jnp.sum(st["alive"], dtype=i32) > jnp.asarray(fit, i32))

    if t0 is None:
        t0 = jnp.asarray(0, i32)
    t_out, st = jax.lax.while_loop(cond, seg_body, (t0, state))
    return st, t_out


def compact_state(state, new_size: int):
    """Sort live lanes to the front (stable) and slice to new_size.

    Returns (sliced live state, finished-results state of the old size,
    ovf flag).  Finished lanes keep their results in the returned 'done'
    copy; live lanes beyond new_size raise ovf.
    """
    i32 = jnp.int32
    alive = state["alive"]
    M = alive.shape[0]
    n_alive = jnp.sum(alive.astype(i32))
    ovf = n_alive > new_size
    # stable compaction via rank scatter (cheaper than a bool argsort
    # at pool width); gathers run at the SLICED width
    rank_a = jnp.cumsum(alive.astype(i32)) - 1
    rank_d = jnp.cumsum((~alive).astype(i32)) - 1 + n_alive
    pos = jnp.where(alive, rank_a, rank_d)
    order = jnp.zeros(M, i32).at[pos].set(jnp.arange(M, dtype=i32))
    take = order[:new_size]
    live = {k: v[take] for k, v in state.items()}
    return live, ovf


def init_walk_state(dt, M: int):
    i32 = jnp.int32
    return dict(
        k=jnp.zeros(M, dt), l=jnp.zeros(M, dt), s=jnp.zeros(M, dt),
        rid=jnp.zeros(M, i32), i=jnp.full(M, -1, i32),
        death=jnp.full(M, -1, i32), mh=jnp.ones(M, dt),
        alive=jnp.zeros(M, jnp.bool_), slot=jnp.full(M, -1, i32),
    )


# ----------------------------------------------------------------------
# pool building / reconstruction / merge / sampling (device-resident)
# ----------------------------------------------------------------------

def build_pool(lep, cnt, GP: int):
    """Flatten per-read LEP buffers into a dense global pool.

    lep: (R, capl, 5) rows (k,l,s,end,pivot); cnt: (R,).
    Returns pool (GP, 7): k,l,s,end,pivot,rid,valid — stable-compacted so
    valid rows keep (read, push) order; plus n_valid and overflow flag.
    """
    R, capl, _ = lep.shape
    dt = lep.dtype
    slot = jnp.arange(capl, dtype=jnp.int32)[None, :]
    valid = slot < cnt[:, None].astype(jnp.int32)            # (R, capl)
    rid = jnp.broadcast_to(jnp.arange(R, dtype=jnp.int32)[:, None],
                           (R, capl))
    flat = lep.reshape(R * capl, 5)
    vflat = valid.reshape(-1)
    rflat = rid.reshape(-1)
    i32 = jnp.int32
    M = vflat.shape[0]
    n = jnp.sum(vflat.astype(i32))
    ovf = n > GP
    # stable compaction via rank scatter (cheaper than a bool argsort
    # at this width)
    rank_v = jnp.cumsum(vflat.astype(i32)) - 1
    rank_i = jnp.cumsum((~vflat).astype(i32)) - 1 + n
    pos = jnp.where(vflat, rank_v, rank_i)
    order = jnp.zeros(M, i32).at[pos].set(jnp.arange(M, dtype=i32))
    take = order[:GP]
    pool = jnp.concatenate([
        flat[take],
        rflat[take][:, None].astype(dt),
        vflat[take][:, None].astype(dt)], axis=1)
    return pool, n, ovf


def walk_pool(fm: DeviceFMIndex, qflat, L: int, pool, stages, mh=None,
              rwflat=None):
    """Run the staged backward walks for every valid pool row.

    pool: (GP, 7) as from build_pool; rows with pivot == 0 die on their
    first step (i0 == -1) which reproduces the pivot==0 fast path.
    stages: list of (lane_cap, max_steps); lane caps decrease.  Stage
    TRANSITIONS are adaptive: each stage walks until the live count
    fits the next cap (or everyone is dead / the global step budget is
    spent), so compaction can never overflow and no stage runs fixed
    extra steps at a stale width.  Walks per lane are deterministic, so
    the results are identical to the unstaged walk.
    mh: per-row min_hits (GP,) — 1 (round 1) if omitted.
    Returns (death (GP,) i32, fk, fl, fs (GP,) dt, ovf, calls) where
    calls is the executed-extension count (the reference's bwt_call
    unit) summed over all walked lanes.
    """
    dt = fm.dtype
    i32 = jnp.int32
    GP = pool.shape[0]
    valid = pool[:, 6] != 0
    if mh is None:
        mh = jnp.ones(GP, dt)

    state = dict(
        k=pool[:, 0], l=pool[:, 1], s=pool[:, 2],
        rid=pool[:, 5].astype(i32),
        i=pool[:, 4].astype(i32) - 1,                  # pivot - 1
        death=jnp.full(GP, -(2), i32),                 # sentinel
        mh=jnp.maximum(mh.astype(dt), 1),
        alive=valid,
        slot=jnp.where(valid, jnp.arange(GP, dtype=i32), -1),
        steps=jnp.zeros(GP, i32),
    )

    death = jnp.full(GP, -2, i32)
    fk = pool[:, 0]
    fl = pool[:, 1]
    fs = pool[:, 2]
    ovf = jnp.asarray(False)
    calls = jnp.asarray(0, i32)
    budget = L + 2                      # a walk can't outlive its pivot
    t = jnp.asarray(0, i32)

    caps = [cap for cap, _ in stages]
    for idx, cap in enumerate(caps):
        if idx > 0:
            state, o = compact_state(state, cap)
            ovf = ovf | o               # never fires: exit is fit-gated
        fit = caps[idx + 1] if idx + 1 < len(caps) else 0
        state, t = walk_stage(fm, qflat, L, budget, state, t0=t, fit=fit,
                              rwflat=rwflat)
        finished = (~state["alive"]) & (state["slot"] >= 0)
        sl = jnp.where(finished, state["slot"], GP)
        death = death.at[sl].set(
            jnp.where(finished, state["death"], 0), mode="drop")
        fk = fk.at[sl].set(jnp.where(finished, state["k"], 0), mode="drop")
        fl = fl.at[sl].set(jnp.where(finished, state["l"], 0), mode="drop")
        fs = fs.at[sl].set(jnp.where(finished, state["s"], 0), mode="drop")
        calls = calls + jnp.sum(jnp.where(finished, state["steps"], 0))
        state["steps"] = jnp.where(finished, 0, state["steps"])
        # finished lanes must not scatter again in later stages
        state["slot"] = jnp.where(finished, -1, state["slot"])
    ovf = ovf | jnp.any(state["alive"])
    calls = calls + jnp.sum(state["steps"])
    return death, fk, fl, fs, ovf, calls


def _pow_u32(base: int, n: int) -> np.ndarray:
    """[base^0 .. base^n] mod 2^32 as uint32."""
    out = np.empty(n + 1, np.uint32)
    v = 1
    for i in range(n + 1):
        out[i] = v
        v = (v * base) & 0xFFFFFFFF
    return out


def walk_pool_dedup(fm: DeviceFMIndex, qflat, ph, L: int, pool, stages,
                    Wb: int = 8, mh=None, rwflat=None):
    """Backward walks with CONTENT-WINDOW dedup — the cross-read,
    cross-position sharing the reference's backward SST trie gets
    (mapping/SST.h:72-92), which position-keyed whole-walk dedup cannot
    capture (measured: 0.01% of steps shared on the 30x bench input,
    because overlapping reads hold the same state at different pivots).

    A walk's next Wb steps depend only on (interval k,s; the Wb
    characters below its position; min_hits) — NOT on the absolute
    position: the interval evolves by consumed content, l evolves in
    lockstep modulo a constant offset, and death maps back through the
    position difference.  So:

      1. group ALL pool rows by (k, s, hash(window), wlen, mh) where
         wlen = min(pivot, Wb);
      2. walk one representative per group for up to Wb steps;
      3. groups whose rep resolved inside the window adopt its outcome
         (death shifted by the pivot delta, l shifted by the initial-l
         delta);
      4. surviving members re-enter at their post-window state and go
         through the exact full-prefix dedup (dedup_pool keeps the
         pivot in its key, so no shifts) + the fit-gated staged walk.

    Short-window groups (pivot < Wb) always resolve in step 2: the rep
    reaches position -1 within wlen steps, and wlen is in the key.
    Exactness: same 64-bit double-hash content compare as dedup_pool;
    (k, s, wlen, mh) compare exactly at group boundaries.

    Returns (death, fk, fl, fs (GP,), ovf, calls, n_groups)."""
    dt = fm.dtype
    i32 = jnp.int32
    u32 = jnp.uint32
    GP = pool.shape[0]
    R, Lh = ph.shape[0], ph.shape[1]
    valid = pool[:, 6] != 0
    rid = pool[:, 5].astype(i32)
    piv = pool[:, 4].astype(i32)
    mh_arr = jnp.ones(GP, dt) if mh is None else \
        jnp.maximum(mh.astype(dt), 1)

    # rolling-hash of the wlen chars below the pivot:  P[n] covers the
    # first n chars (P[n] = ph[:, n-1]);  W(a,b) = P[b] - P[a]*M^(b-a)
    pz = jnp.zeros((R, 1), ph.dtype)
    P1 = jnp.concatenate([pz, ph[:, :, 0]], axis=1).reshape(-1)
    P2 = jnp.concatenate([pz, ph[:, :, 1]], axis=1).reshape(-1)
    wlen = jnp.minimum(piv, Wb)
    bidx = rid * (Lh + 1)
    hi1 = P1[bidx + piv]
    hi2 = P2[bidx + piv]
    lo1 = P1[bidx + piv - wlen]
    lo2 = P2[bidx + piv - wlen]
    pw1 = jnp.asarray(_pow_u32(0x01000193, Wb))[wlen]
    pw2 = jnp.asarray(_pow_u32(0x9E3779B9, Wb))[wlen]
    wh1 = hi1 - lo1 * pw1
    wh2 = hi2 - lo2 * pw2

    keys = [wh1, wh2, pool[:, 0], pool[:, 2], wlen, mh_arr]
    mixes = [wh1, wh2,
             (pool[:, 0] ^ (pool[:, 0] >> 31)).astype(u32),
             (pool[:, 2] ^ (pool[:, 2] >> 31)).astype(u32),
             wlen.astype(u32), mh_arr.astype(u32)]
    CAP0 = stages[0][0]
    rep_take, group, n_groups, ovf0 = _group_rows(keys, mixes, valid,
                                                  CAP0)

    # probe: one rep per group walks up to Wb steps
    rp = pool[rep_take]
    rep_valid = jnp.arange(CAP0, dtype=i32) < n_groups
    st = dict(
        k=rp[:, 0], l=rp[:, 1], s=rp[:, 2],
        rid=rp[:, 5].astype(i32),
        i=rp[:, 4].astype(i32) - 1,
        death=jnp.full(CAP0, -2, i32),
        mh=jnp.maximum(mh_arr[rep_take].astype(dt), 1),
        alive=rep_valid,
        slot=jnp.where(rep_valid, jnp.arange(CAP0, dtype=i32), -1),
        steps=jnp.zeros(CAP0, i32),
    )
    # fit-gated like every other stage: the probe may stop before Wb
    # steps once the live count fits two caps down — reps dead by then
    # adopt as usual, and survivors continue exactly through the
    # full-prefix path from wherever the probe stopped (their remaining
    # window chars are part of the full-prefix key).  Gating at
    # stages[1] would exit before any sharing is captured; stages[2]
    # keeps the probe in the death-heavy early steps without paying the
    # full fixed Wb at pool width.
    fit0 = stages[2][0] if len(stages) > 2 else 0
    st, _t = walk_stage(fm, qflat, L, Wb, st, t0=jnp.asarray(0, i32),
                        fit=fit0, rwflat=rwflat)
    calls = jnp.sum(st["steps"])

    rep_done = ~st["alive"]
    rl0 = rp[:, 1]
    piv_rep = rp[:, 4].astype(i32)
    shift = piv - piv_rep[group]
    g_done = rep_done[group] & valid
    death0 = st["death"][group] + shift
    fk0 = st["k"][group]
    fs0 = st["s"][group]
    fl0 = st["l"][group] - rl0[group] + pool[:, 1]

    # survivors: members continue from the rep's post-window state at
    # their own (shifted) position, through the exact full-prefix path
    g_live = (~rep_done)[group] & valid
    cont_i = st["i"][group] + shift
    cont_pool = jnp.stack([
        st["k"][group],
        st["l"][group] - rl0[group] + pool[:, 1],
        st["s"][group],
        pool[:, 3],
        (cont_i + 1).astype(dt),
        pool[:, 5],
        g_live.astype(dt)], axis=1).astype(pool.dtype)
    CAP1 = stages[1][0] if len(stages) > 1 else CAP0
    rep2, group2, _n2, dovf, take2 = dedup_pool(cont_pool, ph, CAP1,
                                                mh=mh_arr)
    d2r, fk2r, fl2r, fs2r, wovf2, calls2 = walk_pool(
        fm, qflat, L, rep2, stages[1:] if len(stages) > 1 else stages,
        mh=mh_arr[take2], rwflat=rwflat)
    death1 = d2r[group2]
    fk1 = fk2r[group2]
    fs1 = fs2r[group2]
    fl1 = fl2r[group2] - rep2[group2, 1] + cont_pool[:, 1]

    death = jnp.where(g_done, death0,
                      jnp.where(g_live, death1, -2))
    fk = jnp.where(g_done, fk0, jnp.where(g_live, fk1, pool[:, 0]))
    fl = jnp.where(g_done, fl0, jnp.where(g_live, fl1, pool[:, 1]))
    fs = jnp.where(g_done, fs0, jnp.where(g_live, fs1, pool[:, 2]))
    ovf = ovf0 | dovf | wovf2
    return death, fk, fl, fs, ovf, calls + calls2, n_groups


def walk_pool_chain(fm: DeviceFMIndex, rwflat, L: int, pool, CAPW: int,
                    mh=None, W: int = REV_W, segs=(1, 4, 16)):
    """Backward walks in W-char CHAINED ROUNDS with per-round exact
    content grouping — the round-5 replacement for the staged per-step
    walk (walk_pool/walk_pool_dedup).

    Per round, every live walk is grouped by (k, s, the W chars below
    its position packed exactly into one uint32); ONE representative
    per group runs W backward extends (_chain_walk), and every member
    evaluates its own death (min_hits or ambiguous char) on the shared
    chain states lane-side.  Exactness is the mirror of the forward
    chain memo's l-domain lemma: a backward step ranks at the k
    coordinate, so (k, s, content) determines every k_j/s_j of the
    chain while each member's l re-bases by its own offset.  The
    position is NOT in the key — walks at different pivots sharing
    content share work (the reference backward trie's sharing,
    SST.h:72-92) — and neither is min_hits (stops are lane-side), so
    sharing is strictly wider than walk_pool_dedup's.

    vs the per-step walker this collapses W per-step select chains and
    W char gathers into one round of each, and runs the extends at
    representative width.  ~70% of walks die inside their first round
    (walks <= 8 steps hold 69% of backward steps on the bench input),
    so the lane width drops by `segs` divisors with rank-scatter
    compaction exactly like chain_scan's segments.

    pool: (GP, >=7) rows as from build_pool (cols k,l,s,end,pivot,rid,
    valid[,task]).  Returns (death, fk, fl, fs (GP,), ovf, calls,
    n_groups) — the walk_pool_dedup contract: death/final-state per
    pool row bit-exact vs the per-step walker.
    """
    dt = fm.dtype
    i32 = jnp.int32
    u32 = jnp.uint32
    GP = pool.shape[0]
    valid = pool[:, 6] != 0
    mh_all = jnp.ones(GP, dt) if mh is None else \
        jnp.maximum(mh.astype(dt), 1)
    n_valid = jnp.sum(valid, dtype=i32)
    ovf = n_valid > CAPW
    ALL4 = np.uint32(sum(4 << (3 * j) for j in range(REV_W)))

    # stable rank-scatter compaction of valid rows into CAPW lanes
    crank = jnp.cumsum(valid, dtype=i32) - 1
    tgt = jnp.where(valid, crank, CAPW)

    def compact(col, dtype=None):
        z = jnp.zeros(CAPW, dtype if dtype is not None else col.dtype)
        return z.at[tgt].set(col.astype(z.dtype), mode="drop")

    st = dict(
        k=compact(pool[:, 0]), l=compact(pool[:, 1]),
        s=compact(pool[:, 2]),
        rid=compact(pool[:, 5], i32),
        i=compact(pool[:, 4].astype(i32) - 1, i32),
        mh=compact(mh_all),
        slot=compact(jnp.where(valid, jnp.arange(GP, dtype=i32), GP),
                     i32),
        alive=jnp.arange(CAPW, dtype=i32) < n_valid,
        death=jnp.zeros(GP, i32) - 2,
        fk=pool[:, 0], fl=pool[:, 1], fs=pool[:, 2],
        calls=jnp.asarray(0, i32),
        ngrp=jnp.asarray(0, i32),
        rnd=jnp.asarray(0, i32),
    )
    RCAP = L + 2
    jj = jnp.arange(W, dtype=i32)[None, :]

    def make_body(w: int, Uw: int):
      def body(st):
        st = dict(st)
        alive = st["alive"]
        k, l, s, i = st["k"], st["l"], st["s"], st["i"]
        idx = jnp.clip(st["rid"] * L + jnp.clip(i, 0, L - 1), 0,
                       rwflat.shape[0] - 1)
        rw = jnp.where(i >= 0, rwflat[idx], ALL4)

        # ---- group by exact (window, k, s); sort on one 32-bit mix
        # (collision only splits a group), boundary-compare full keys
        mix = rw ^ ((k.astype(u32) ^ (k >> 31).astype(u32)) *
                    u32(0x9E3779B9)) ^ \
            ((s.astype(u32) ^ (s >> 31).astype(u32)) * u32(0x85EBCA6B))
        mix = (mix ^ (mix >> u32(15))) * u32(0xC2B2AE35)
        order = jnp.argsort(jnp.where(
            alive, (mix >> u32(1)).astype(i32), jnp.iinfo(i32).max)
        ).astype(i32)
        vs = alive[order]
        ko = [x[order] for x in (rw, k, s)]
        diff = jnp.concatenate([
            jnp.asarray([True]),
            jnp.stack([x[1:] != x[:-1] for x in ko]).any(axis=0)])
        head = vs & diff
        gidx_sorted = jnp.cumsum(head, dtype=i32) - 1
        n_u = jnp.sum(head, dtype=i32)
        rep_take = jnp.zeros(Uw, i32).at[
            jnp.where(head & (gidx_sorted < Uw), gidx_sorted, Uw)].set(
            order, mode="drop")
        sortpos = jnp.zeros(w, i32).at[order].set(
            jnp.arange(w, dtype=i32))
        group = jnp.clip(gidx_sorted[sortpos], 0, Uw - 1)
        walked = alive & (gidx_sorted[sortpos] < jnp.minimum(n_u, Uw))

        # ---- one representative per group walks backward extends,
        # stopping at the group's smallest min_hits (the rep then
        # executes exactly its longest-lived consumer's steps)
        rep_valid = (jnp.arange(Uw, dtype=i32) <
                     jnp.minimum(n_u, Uw)) & alive[rep_take]
        big_mh = jnp.asarray(jnp.iinfo(i32).max, dt)
        gmin = jax.ops.segment_min(
            jnp.where(vs & (gidx_sorted < Uw), st["mh"][order], big_mh),
            jnp.clip(gidx_sorted, 0, Uw - 1), num_segments=Uw)
        rep_rw = rw[rep_take]
        rep_bases = jnp.stack(
            [(rep_rw >> np.uint32(3 * j)) & np.uint32(7)
             for j in range(W)], axis=1).astype(i32)
        ck, cl, cs, ln = _chain_walk(
            fm, rep_bases, W, k[rep_take], l[rep_take], s[rep_take],
            rep_valid, is_back=True, stop_s=gmin)
        st["calls"] = st["calls"] + jnp.sum(
            jnp.where(rep_valid, ln, 0), dtype=i32)
        st["ngrp"] = st["ngrp"] + jnp.minimum(n_u, Uw)

        # ---- every walked lane consumes the shared chain; k and s
        # are group-identical, l re-bases by the member offset
        CK = ck[group]
        CS = cs[group]
        CL = cl[group] + (l - l[rep_take][group])[:, None]
        lng = ln[group]
        real = jj < lng[:, None]
        amb_here = (jj == lng[:, None]) & (lng[:, None] < W)
        die_j = amb_here | (real & (CS < st["mh"][:, None]))
        has_die = jnp.any(die_j, axis=1) & walked
        dj = jnp.argmax(die_j, axis=1).astype(i32)
        # state at the death = state BEFORE the killing step (the
        # per-step walker does not update on the dying step)
        prevK = jnp.concatenate([k[:, None], CK[:, :-1]], axis=1)
        prevL = jnp.concatenate([l[:, None], CL[:, :-1]], axis=1)
        prevS = jnp.concatenate([s[:, None], CS[:, :-1]], axis=1)
        djc = dj[:, None]
        dK = jnp.take_along_axis(prevK, djc, axis=1)[:, 0]
        dL = jnp.take_along_axis(prevL, djc, axis=1)[:, 0]
        dS = jnp.take_along_axis(prevS, djc, axis=1)[:, 0]
        died = has_die
        dsl = jnp.where(died, st["slot"], GP)
        st["death"] = st["death"].at[dsl].set(
            jnp.where(died, i - dj, 0), mode="drop")
        st["fk"] = st["fk"].at[dsl].set(jnp.where(died, dK, 0),
                                        mode="drop")
        st["fl"] = st["fl"].at[dsl].set(jnp.where(died, dL, 0),
                                        mode="drop")
        st["fs"] = st["fs"].at[dsl].set(jnp.where(died, dS, 0),
                                        mode="drop")

        # ---- survivors advance W chars; un-walked lanes retry
        through = walked & ~has_die
        st["k"] = jnp.where(through, CK[:, W - 1], k)
        st["l"] = jnp.where(through, CL[:, W - 1], l)
        st["s"] = jnp.where(through, CS[:, W - 1], s)
        st["i"] = jnp.where(through, i - W, i)
        st["alive"] = alive & ~died
        st["rnd"] = st["rnd"] + 1
        return st
      return body

    lane_keys = ("k", "l", "s", "rid", "i", "mh", "slot")
    widths = []
    for d in segs:
        w2 = max(CAPW // d, 256)
        if not widths or w2 < widths[-1]:
            widths.append(w2)
    for ix, w in enumerate(widths):
        nxtw = widths[ix + 1] if ix + 1 < len(widths) else 0
        body_w = make_body(w, max(w // 2, 64))

        def cond(st, nxtw=nxtw):
            return (st["rnd"] < RCAP) & \
                (jnp.sum(st["alive"], dtype=i32) > nxtw)

        st = jax.lax.while_loop(cond, body_w, st)
        if nxtw:
            lalive = st["alive"]
            crank2 = jnp.cumsum(lalive, dtype=i32) - 1
            tgt2 = jnp.where(lalive, crank2, nxtw)
            st = dict(st)
            for kk in lane_keys:
                st[kk] = jnp.zeros(nxtw, st[kk].dtype).at[tgt2].set(
                    st[kk], mode="drop")
            st["alive"] = jnp.zeros(nxtw, jnp.bool_).at[tgt2].set(
                lalive, mode="drop")
    ovf = ovf | jnp.any(st["alive"])
    return (st["death"], st["fk"], st["fl"], st["fs"], ovf,
            st["calls"], st["ngrp"])


def reconstruct(pool, death, fk, fl, fs, min_seed_len: int, group_cols):
    """Emission flags + SMEM rows from walked pool rows.

    Within a (group) run of rows (push order), entry sizes DEcrease with
    push index p, so ascending-size order is reversed push order and
    deaths are non-decreasing in p.  The reference's first-slot emission
    + equal-size dedup (comp_seed.cpp:114-137) reduces to:
        emit(p)  <=>  last row of group  OR  death[p] < death[p+1]
    with beg = death+1, end = row end, interval = walked final state.
    group_cols: columns of pool identifying the group (e.g. rid+pivot).
    Returns (emit, rid, k, l, s, beg, end) all (GP,).
    """
    GP = pool.shape[0]
    valid = pool[:, 6] != 0
    gid = [pool[:, c] for c in group_cols]
    nxt_same = valid & jnp.concatenate([
        (jnp.stack([g[1:] == g[:-1] for g in gid]).all(axis=0) &
         (pool[1:, 6] != 0)), jnp.asarray([False])])
    is_last = valid & ~nxt_same
    death_next = jnp.concatenate([death[1:], jnp.asarray([-2], death.dtype)])
    emit = valid & (is_last | (death < death_next))
    beg = death + 1
    end = pool[:, 3].astype(jnp.int32)
    ok = emit & ((end - beg) >= min_seed_len) & (fs > 0)
    return ok, pool[:, 5].astype(jnp.int32), fk, fl, fs, beg, end


# ----------------------------------------------------------------------
# forward sweep worklist with cross-read reuse (the forward SST,
# mapping/SST.h:60-71 query_forward_child)
# ----------------------------------------------------------------------
#
# The reference's forward SST memoizes every (trie-path, base) forward
# extension across a batch.  Batch formulation here: the round-1 scan is
# a sequence of pivot SWEEPS per read; sweeps run as a staged worklist
# (one lane per read), and within each stage — whose behavior depends
# only on (pivot, position, interval, next-B-characters) — lanes are
# grouped by that key and only one representative per group pays the
# occ-gather cost.  Prefix-sharing reads (what compressor reordering
# produces) stay in one group until the divergence point enters the
# stage window, so the trie's sharing is captured at stage granularity.

_BM1 = 0x100000001B3
_BM2 = 0x9E3779B97F4A7C15
_SALT1 = 1
_SALT2 = 5


def _pow_u64(base: int, e: int) -> np.uint64:
    r = np.uint64(1)
    b = np.uint64(base)
    with np.errstate(over="ignore"):
        while e:
            if e & 1:
                r = r * b
            b = b * b
            e >>= 1
    return r


def padded_prefix_state(qarr, pad: int):
    """Prefix-hash accumulators of the 4-padded rows, length L+pad+1.

    A[r, p] = poly hash of row[:p] (row extended with 4s), for two
    independent 64-bit bases.  Window hash of row[p:p+B] is then
    A[p+B] - A[p] * BM**B — the per-stage dedup key.
    """
    R, L = qarr.shape
    ext = jnp.concatenate(
        [qarr, jnp.full((R, pad), 4, qarr.dtype)], axis=1)

    def acc(base, salt):
        a = ext.astype(jnp.uint64) + jnp.uint64(salt)
        m = jnp.full(ext.shape, jnp.uint64(base), jnp.uint64)

        def comb(x, y):
            m1, a1 = x
            m2, a2 = y
            return m1 * m2, a1 * m2 + a2

        _, h = jax.lax.associative_scan(comb, (m, a), axis=1)
        return jnp.concatenate(
            [jnp.zeros((R, 1), jnp.uint64), h], axis=1)

    return acc(_BM1, _SALT1), acc(_BM2, _SALT2)


def next_nonamb(qarr):
    """nxt[r, p] = smallest p' >= p with q[r, p'] < 4, else L.

    Replaces the original scan's one-iteration-per-N pivot skipping
    (phase 0 of _scan_one) with a precomputed jump table.
    """
    R, L = qarr.shape
    pos = jnp.where(qarr < 4, jnp.arange(L, dtype=jnp.int32)[None, :], L)
    rev = jnp.flip(pos, axis=1)
    run = jax.lax.associative_scan(jnp.minimum, rev, axis=1)
    return jnp.flip(run, axis=1)


def _fwd_stage_walk(fm: DeviceFMIndex, qflat, nxtflat, L: int, B: int,
                    state, mh, advance: bool, mode: str = "lep",
                    min_len: int = 0, max_intv: int = 0):
    """Walk up to B forward-sweep iterations for U representative lanes,
    INCLUDING pivot respawns, as long as every consumed position stays
    inside the lane's content window [pos0, pos0+B) — the region the
    dedup key hashes, so group members are guaranteed to behave
    identically.  Lanes whose sweep leaves the window freeze until the
    stage boundary; amb stops whose next pivot lies outside the window
    park in ``waiting`` for the boundary respawn.

    state: k, l, s (dt), pos, pivot, rid (i32), alive (bool) over U.
    Returns final state + per-step push records (pre-extension interval,
    position, pivot), waiting info and per-lane occ-step counts.
    """
    dt = fm.dtype
    i32 = jnp.int32
    U = state["k"].shape[0]
    pos_end = state["pos"] + jnp.asarray(B, i32)   # window limit

    init = dict(state)
    init["j"] = jnp.asarray(0, i32)
    init["waiting"] = jnp.zeros(U, jnp.bool_)
    init["wait_npv"] = jnp.zeros(U, i32)
    init["steps"] = jnp.zeros(U, i32)
    init["pf"] = jnp.zeros((U, B), jnp.bool_)
    init["pk"] = jnp.zeros((U, B), dt)
    init["pl"] = jnp.zeros((U, B), dt)
    init["ps"] = jnp.zeros((U, B), dt)
    init["pe"] = jnp.zeros((U, B), i32)
    init["pp"] = jnp.zeros((U, B), i32)

    def body(st):
        j = st["j"]
        pos = st["pos"]
        active = st["alive"] & (pos < pos_end)
        base = jnp.where(
            pos < jnp.asarray(L, i32),
            qflat[jnp.clip(st["rid"] * L + pos, 0,
                           qflat.shape[0] - 1)].astype(i32),
            4)
        c = 3 - jnp.clip(base, 0, 3)
        ik = jnp.stack([st["k"], st["l"], st["s"]], axis=-1)
        okc = dfm.extend_sel_batch(fm, ik, c, is_back=False)  # (U, 3)
        amb = base > 3
        if mode == "r3":
            # greedy round-3 segment (bwt_seed_strategy1, bwt.c:358-379):
            # emit the POST-extension interval when it first drops below
            # max_intv at length >= min_len, then restart past it
            hit = active & ~amb & \
                (okc[:, 2] < jnp.asarray(max_intv, fm.dtype)) & \
                ((pos - st["pivot"]) >= jnp.asarray(min_len, i32))
            push = hit
            stop = active & (hit | amb)
            cont = active & ~stop
            rec_k, rec_l, rec_s = okc[:, 0], okc[:, 1], okc[:, 2]
            rec_e = pos + 1
        else:
            changed = okc[:, 2] != st["s"]
            small = okc[:, 2] < mh
            push = active & (amb | changed)
            stop = active & (amb | (changed & small))
            cont = active & ~stop
            rec_k, rec_l, rec_s = st["k"], st["l"], st["s"]
            rec_e = pos

        st = dict(st)
        st["pf"] = st["pf"].at[:, j].set(push)
        st["pk"] = st["pk"].at[:, j].set(rec_k)
        st["pl"] = st["pl"].at[:, j].set(rec_l)
        st["ps"] = st["ps"].at[:, j].set(rec_s)
        st["pe"] = st["pe"].at[:, j].set(rec_e)
        st["pp"] = st["pp"].at[:, j].set(st["pivot"])
        st["steps"] = st["steps"] + active.astype(i32)

        k = jnp.where(cont, okc[:, 0], st["k"])
        l = jnp.where(cont, okc[:, 1], st["l"])
        s = jnp.where(cont, okc[:, 2], st["s"])
        newpos = jnp.where(cont, pos + 1, pos)
        alive = st["alive"] & ~stop
        pivot = st["pivot"]
        waiting = st["waiting"]
        wait_npv = st["wait_npv"]

        if advance:
            # in-window respawn (_scan_one phase 0 without the extra
            # iteration): non-amb stop re-consumes `pos` as new pivot;
            # amb stop jumps to the next non-amb IF it stays inside the
            # window — a content-determined decision, so group-safe.
            # round 3 always restarts past the current position
            # (bwt_seed_strategy1 returns i+1 on hit and amb alike)
            rs_here = stop & ~amb if mode != "r3" else \
                jnp.zeros_like(stop)
            npv = pos + 1
            nx = jnp.where(
                npv < jnp.asarray(L, i32),
                nxtflat[jnp.clip(st["rid"] * L + npv, 0,
                                 nxtflat.shape[0] - 1)],
                L)
            # a jump target outside the window (or at the L sentinel,
            # where lanes' beyond-window content may differ) must defer
            # to the per-lane boundary respawn
            in_win = (nx < pos_end) & (nx < jnp.asarray(L, i32))
            jumper = stop if mode == "r3" else (stop & amb)
            rs_jump = jumper & in_win
            park = jumper & ~in_win
            newpiv = jnp.where(rs_here, pos, nx)
            respawn = rs_here | rs_jump
            baseN = jnp.where(
                newpiv < jnp.asarray(L, i32),
                qflat[jnp.clip(st["rid"] * L + newpiv, 0,
                               qflat.shape[0] - 1)].astype(i32),
                4)
            ikN = _set_intv(fm, jnp.clip(baseN, 0, 3)).T
            # a jump target that is padding (no pivot left) ends the lane
            respawn = respawn & (baseN < 4)
            pivot = jnp.where(respawn, newpiv, pivot)
            k = jnp.where(respawn, ikN[:, 0], k)
            l = jnp.where(respawn, ikN[:, 1], l)
            s = jnp.where(respawn, ikN[:, 2], s)
            newpos = jnp.where(respawn, newpiv + 1, newpos)
            alive = alive | respawn
            waiting = waiting | park
            wait_npv = jnp.where(park, npv, wait_npv)

        st["k"] = k
        st["l"] = l
        st["s"] = s
        st["pos"] = newpos
        st["pivot"] = pivot
        st["alive"] = alive
        st["waiting"] = waiting
        st["wait_npv"] = wait_npv
        st["j"] = j + 1
        return st

    SEG = 8

    def guarded(st):
        # the segmented loop may overshoot B; freeze state past it
        return jax.lax.cond(st["j"] < jnp.asarray(B, i32), body,
                            lambda s: s, st)

    def seg(st):
        return jax.lax.fori_loop(0, min(SEG, B), lambda _, x: guarded(x),
                                 st)

    def cond(st):
        return (st["j"] < B) & \
            jnp.any(st["alive"] & (st["pos"] < pos_end))

    return jax.lax.while_loop(cond, seg, init)


def fwd_stages_for(R: int, L: int):
    """Stage schedule (rep_cap, step_budget) for the round-1 forward
    scan.  Budgets must sum past the worst case ~2L (each pivot restart
    re-consumes one position); rep caps below R are where the gather
    savings come from — overflow falls back to the undeduplicated scan,
    so caps are sized for the ~25-30% sharing the reference's SST
    reports on reordered input (main.cpp:206-207), not the best case."""
    MAXW = L + 2
    return [(R, 8), (R, 8), (R - R // 8, 16), (R - R // 4, 32),
            (R - R // 4, 64), (R - R // 4, MAXW), (R // 2, MAXW)]


def forward_scan_dedup(fm: DeviceFMIndex, qarr, rlens, GP: int,
                       stages, min_hits=None, pivots0=None, rids=None,
                       advance: bool = True, mode: str = "lep",
                       min_len: int = 0, max_intv: int = 0,
                       record_lane_index: bool = False, active=None):
    """Round-1 forward LEP scan with cross-read sweep deduplication.

    Produces the same LEP pool as make_scan(advance=True) + build_pool —
    rows (k,l,s,end,pivot,rid,valid) sorted by (rid, pivot, end), which
    is the per-read push order reconstruct() requires — but each stage
    walks only one representative per (pivot, pos, interval,
    content-window) group.

    Returns (pool (GP,7), n_rows, ovf, fwd_queries, fwd_calls).
    """
    dt = fm.dtype
    i32 = jnp.int32
    R, L = qarr.shape
    n_lanes = R if rids is None else rids.shape[0]
    qflat = qarr.reshape(-1)
    rlens = rlens.astype(i32)
    max_b = max(b for _, b in stages)
    A1, A2 = padded_prefix_state(qarr, max_b)
    nxt = next_nonamb(qarr)
    nxtflat = nxt.reshape(-1)
    lane_rid = jnp.arange(R, dtype=i32) if rids is None \
        else rids.astype(i32)
    lane_rlen = rlens[lane_rid]
    mh = jnp.ones(n_lanes, dt) if min_hits is None \
        else jnp.maximum(min_hits.astype(dt), 1)

    # initial spawn (phase 0 of _scan_one): pivot = first non-amb
    p0 = jnp.zeros(n_lanes, i32) if pivots0 is None \
        else pivots0.astype(i32)
    pivot = nxt[lane_rid, jnp.clip(p0, 0, L - 1)]
    alive = (pivot < lane_rlen) & (lane_rlen > 0)
    if pivots0 is not None:
        alive = alive & (p0 < lane_rlen)
    if active is not None:
        alive = alive & active
    base0 = qflat[jnp.clip(lane_rid * L + pivot, 0, qflat.shape[0] - 1)]
    ik0 = _set_intv(fm, jnp.clip(base0.astype(i32), 0, 3)).T   # (n, 3)
    k = jnp.where(alive, ik0[:, 0], 0)
    l = jnp.where(alive, ik0[:, 1], 0)
    s = jnp.where(alive, ik0[:, 2], 0)
    pos = pivot + 1

    # pool carried as six 1D columns (column scatters are cheaper than
    # a (n*B, 7) row scatter — see chain_scan); validity
    # is synthesized from the cursor (pushes fill slots contiguously)
    pool_c = [jnp.zeros(GP, dt) for _ in range(6)]
    cursor = jnp.asarray(0, i32)
    povf = jnp.asarray(False)
    uovf = jnp.asarray(False)
    fq = jnp.asarray(0, i32)
    fc = jnp.asarray(0, i32)
    big = jnp.iinfo(jnp.int64).max

    for (U, B) in stages:
        U = min(U, n_lanes)
        # ---- group lanes by (l-interval, B-char content window, mh).
        # Deliberately NOT by position: FM states depend only on the
        # consumed substring, so two reads covering the same genomic
        # region share walks at *different* offsets — the dominant
        # redundancy in compressor-reordered batches.  All positions in
        # the rep's outcome are shifted per lane afterwards.
        #
        # The key uses (l, s), NOT (k, s): a forward step ranks at the
        # l coordinate (extend_batch is_back=False, ops/fm.py:91-95), so
        # every size/stop decision is a function of (l, s, content)
        # while k only accumulates deltas that are themselves functions
        # of (l, s, base).  Keying on k instead would (a) wrongly merge
        # lanes whose consumed strings are right-extensions of each
        # other — same (k, s), different l, divergent futures (see
        # test_forward_scan_dedup_l_domain_key) — and (b) miss the
        # legitimate mirror case (same l, different k: one lane entered
        # the shared region mid-sweep later than the other), which is
        # the phase-shifted sharing compressor-reordered batches are
        # full of.  Each member's k is delta-adjusted on scatter, the
        # exact mirror of the backward dedup's l adjustment
        # (seeder2.py::j_round1).
        pwr1 = jnp.uint64(_pow_u64(_BM1, B))
        pwr2 = jnp.uint64(_pow_u64(_BM2, B))
        pcol = jnp.clip(pos, 0, L)
        w1 = A1[lane_rid, pcol + B] - A1[lane_rid, pcol] * pwr1
        w2 = A2[lane_rid, pcol + B] - A2[lane_rid, pcol] * pwr2
        valid = alive
        keys = [w1, w2, l.astype(jnp.uint64), s.astype(jnp.uint64),
                mh.astype(jnp.uint64)]
        if mode == "r3":
            # the hit test reads the segment length pos - pivot, so
            # group members must share it
            keys.append((pos - pivot).astype(jnp.uint64))
        # sort by ONE avalanched 64-bit mix of the full key (cheaper
        # than a multi-key int64 lexsort); the boundary
        # test still compares every key, so a mix collision only splits
        # a group (one extra rep walk), never merges one
        gh = keys[0]
        for i, x in enumerate(keys[1:]):
            gh = (gh ^ (x * jnp.uint64(_MX1 + 2 * i))) * jnp.uint64(_MX3)
            gh = gh ^ (gh >> jnp.uint64(31))
        order = jnp.argsort(jnp.where(
            valid, gh >> jnp.uint64(1),
            jnp.uint64(big)).astype(jnp.int64)).astype(i32)
        ks = [x[order] for x in keys]
        vs = valid[order]
        diff = jnp.concatenate([
            jnp.asarray([True]),
            jnp.stack([x[1:] != x[:-1] for x in ks]).any(axis=0)])
        head = vs & diff
        gidx_sorted = jnp.cumsum(head.astype(i32)) - 1
        n_u = jnp.sum(head.astype(i32))
        uovf = uovf | (n_u > U)
        rep_take = jnp.zeros(U, i32).at[
            jnp.where(head & (gidx_sorted < U), gidx_sorted, U)].set(
            order, mode="drop")
        sortpos = jnp.zeros(n_lanes, i32).at[order].set(
            jnp.arange(n_lanes, dtype=i32))
        group = jnp.clip(gidx_sorted[sortpos], 0, U - 1)    # lane->rep row

        # ---- walk the representatives
        rep_valid = jnp.arange(U, dtype=i32) < n_u
        st = dict(
            k=k[rep_take], l=l[rep_take], s=s[rep_take],
            pos=pos[rep_take], pivot=pivot[rep_take],
            rid=lane_rid[rep_take],
            alive=alive[rep_take] & rep_valid)
        st = _fwd_stage_walk(fm, qflat, nxtflat, L, B, st, mh[rep_take],
                             advance, mode=mode, min_len=min_len,
                             max_intv=max_intv)
        fq = fq + jnp.sum(jnp.where(valid, st["steps"][group], 0))
        fc = fc + jnp.sum(jnp.where(rep_valid, st["steps"], 0))

        # ---- scatter outcomes back to every lane in the group; every
        # rep-recorded position is rep-absolute, so shift by the lane's
        # offset delta; a pivot equal to the rep's stage-entry pivot
        # predates any in-stage respawn and maps to the lane's own
        # entry pivot (respawned pivots are >= the entry pos, so the
        # entry value can never collide with a respawn value)
        was = alive
        rep_pre = pos[rep_take]          # rep pre-stage positions (U,)
        rep_piv0 = pivot[rep_take]       # rep entry pivots (U,)
        rep_k0 = k[rep_take]             # rep entry k (U,)
        delta = pos - rep_pre[group]
        piv0_g = rep_piv0[group]
        dk = k - rep_k0[group]           # member-vs-rep k offset

        def shift_pos(v):
            return v + delta

        def shift_piv(v, own):
            return jnp.where(v == piv0_g, own, v + delta)

        # flush this stage's pushes (per lane, from its rep's record).
        # A recorded pivot equal to the rep's entry pivot identifies a
        # pre-respawn row (respawned pivots are >= the entry pos, which
        # is > the entry pivot, so no collision): those rows inherit the
        # member's entry-k offset dk; post-respawn rows are fully
        # content-determined and shared verbatim.
        pf = st["pf"][group] & was[:, None]                   # (n, B)
        ends = st["pe"][group] + delta[:, None]
        pre_respawn = st["pp"][group] == piv0_g[:, None]
        pivs = jnp.where(pre_respawn, pivot[:, None],
                         st["pp"][group] + delta[:, None])
        pks = jnp.where(pre_respawn, st["pk"][group] + dk[:, None],
                        st["pk"][group])
        row_id = jnp.arange(n_lanes, dtype=i32) if record_lane_index \
            else lane_rid
        cols = (pks.reshape(-1),
                st["pl"][group].reshape(-1),
                st["ps"][group].reshape(-1),
                ends.reshape(-1).astype(dt),
                pivs.reshape(-1).astype(dt),
                jnp.broadcast_to(row_id[:, None], (n_lanes, B))
                .reshape(-1).astype(dt))
        pflat = pf.reshape(-1)
        rank = jnp.cumsum(pflat.astype(i32)) - 1
        slot = jnp.where(pflat, cursor + rank, GP)
        pool_c = [c.at[slot].set(v, mode="drop")
                  for c, v in zip(pool_c, cols)]
        n_push = jnp.sum(pflat.astype(i32))
        cursor = cursor + n_push
        povf = povf | (cursor > GP)

        k = jnp.where(was,
                      jnp.where(st["pivot"][group] == piv0_g,
                                st["k"][group] + dk, st["k"][group]),
                      k)
        l = jnp.where(was, st["l"][group], l)
        s = jnp.where(was, st["s"][group], s)
        pivot = jnp.where(was, shift_piv(st["pivot"][group], pivot),
                          pivot)
        pos = jnp.where(was, shift_pos(st["pos"][group]), pos)
        still = was & st["alive"][group]
        parked = was & st["waiting"][group]
        wait_npv = shift_pos(st["wait_npv"][group])

        # ---- boundary respawn for amb stops whose next pivot fell
        # outside the stage window
        if advance:
            newpiv = nxt[lane_rid, jnp.clip(wait_npv, 0, L - 1)]
            newpiv = jnp.where(wait_npv >= L, L, newpiv)
            respawn = parked & (newpiv < lane_rlen)
            baseN = qflat[jnp.clip(lane_rid * L + newpiv, 0,
                                   qflat.shape[0] - 1)]
            ikN = _set_intv(fm, jnp.clip(baseN.astype(i32), 0, 3)).T
            pivot = jnp.where(respawn, newpiv, pivot)
            k = jnp.where(respawn, ikN[:, 0], k)
            l = jnp.where(respawn, ikN[:, 1], l)
            s = jnp.where(respawn, ikN[:, 2], s)
            pos = jnp.where(respawn, newpiv + 1, pos)
            alive = still | respawn
        else:
            alive = still

    ovf = povf | uovf | jnp.any(alive)

    # ---- final order: valid rows by (rid, pivot, end) = push order,
    # as one packed int64 key (bounds are static)
    pvalid = jnp.arange(GP, dtype=i32) < cursor
    EB = 2 * L + max_b + 4            # conservative: end < L in practice
    PB = 2 * L + 4                    # conservative: pivot < L in practice
    kdt = i32 if (max(R, n_lanes) + 2) * EB * PB < 2**31 else jnp.int64
    okey = (pool_c[5].astype(kdt) * PB +
            pool_c[4].astype(kdt)) * EB + pool_c[3].astype(kdt)
    forder = jnp.argsort(
        jnp.where(pvalid, okey, jnp.iinfo(kdt).max)).astype(i32)
    # permute by scatter (see chain_scan epilogue)
    rankp = jnp.zeros(GP, i32).at[forder].set(jnp.arange(GP, dtype=i32))
    pool = jnp.stack(
        [jnp.zeros(GP, dt).at[rankp].set(c) for c in
         list(pool_c) + [pvalid.astype(dt)]], axis=1)
    return pool, cursor, ovf, fq, fc


CHAIN_W = 8           # extension-chain chunk width (see chain_scan)

# splitmix64-style avalanche constants for the memo's slot hash
_MX1 = 0xBF58476D1CE4E5B9
_MX2 = 0x94D049BB133111EB
_MX3 = 0x9E3779B97F4A7C15


def make_chain_memo(H: int, M: int, W: int, dt):
    """Zeroed chain-memo state (the cross-round SST).

    A direct-mapped hash TABLE of H slots (power of two) holds the keys
    — (l0, s0, EXACT 3-bit-packed W-char content window) — plus the
    chain metadata (entry k0, length, pointer); the chain state
    sequences live in a dense append-only store of M rows.  Collisions
    evict (the newest entry wins) and a full store stops inserting:
    both only LOSE reuse, never correctness, so unlike every other cap
    in this file the memo needs no overflow fallback.  Lookup and
    insert are O(lanes) gathers and scatters per round — no O(M) sort
    ever touches the table (the reference trie's pointer-chasing
    lookup, SST.h:60-92, costs O(1) per child for the same reason).

    Layout favours 32-bit words (64-bit gathers, scatters and sorts
    move twice the bytes): at W <= 10 the
    window content packs EXACTLY into one uint32 (3 bits per code,
    codes 0..4), so the key needs no 128-bit rolling hash at all —
    matching is exact, not probabilistic.

    Round-5 packing: the whole table is ONE (H, 8) 2D array of the
    index dtype — columns [window, l0, s0, k0, len, ptr, valid, pad] —
    so a probe is ONE row gather and an insert ONE row scatter, where
    a SoA layout would pay seven separate gathers per while-loop
    round.  The chain
    store likewise fuses (ck|cl|cs) into one (M, 3W) array: one
    consumer row gather per round instead of three.  The u32 window
    key is stored bijectively in the dt column (bitcast at 32-bit,
    zero-extend at 64-bit), so matching stays exact."""
    zed = jnp.zeros
    assert H & (H - 1) == 0, "H must be a power of two"
    assert 3 * W <= 32, "chain window must pack into uint32 (W <= 10)"
    return dict(
        tbl=zed((H, 8), dt),
        cst=zed((M, 3 * W), dt),
        cur=jnp.asarray(0, jnp.int32),
    )


MEMO_KEYS = ("tbl", "cst", "cur")

# tbl column indices
_T_W, _T_L0, _T_S0, _T_K0, _T_LN, _T_P, _T_V = range(7)


def _w_store(wv, dt):
    """uint32 window key -> its bijective image in the table dtype."""
    if np.dtype(dt).itemsize == 8:
        return wv.astype(jnp.int64)
    return jax.lax.bitcast_convert_type(wv, jnp.int32)


def _slot_hash(wv, l, s, H: int):
    """Avalanched slot index in [0, H) from the full chain key."""
    z = wv.astype(jnp.uint64) ^ \
        (l.astype(jnp.uint64) * jnp.uint64(_MX1)) ^ \
        (s.astype(jnp.uint64) * jnp.uint64(_MX2))
    z = (z ^ (z >> jnp.uint64(33))) * jnp.uint64(_MX1)
    z = z ^ (z >> jnp.uint64(29))
    return (z & jnp.uint64(H - 1)).astype(jnp.int32)


def packed_windows(qarr, W: int):
    """win[r, p] = 3-bit-packed codes of row r's chars [p, p+W), the
    row extended with 4s; p in [0, L+2).  The EXACT chain-key content
    (what padded_prefix_state hashes for the staged dedup) in one
    uint32 — flat, for cheap 1D gathers."""
    R, L = qarr.shape
    ext = jnp.concatenate(
        [qarr, jnp.full((R, W + 2), 4, qarr.dtype)],
        axis=1).astype(jnp.uint32)
    win = jnp.zeros((R, L + 2), jnp.uint32)
    for j in range(W):
        win = win | (ext[:, j:j + L + 2] << np.uint32(3 * j))
    return win.reshape(-1)


def _chain_walk(fm: DeviceFMIndex, bases, W: int, k, l, s, valid,
                is_back: bool = False, stop_s=None):
    """W pure extensions from (k, l, s) over the pre-decoded window
    characters ``bases`` (U, W) — the mode-free unit the memos store.
    Forward mode extends on the complement (the reference's c =
    3 - seq[i] trick, comp_seed.cpp:78); backward mode extends on the
    character itself.  Recording stops at the first ambiguous base
    (code > 3), where every consumer mode stops anyway; ln < W encodes
    that amb offset.  The chars come decoded from the probe's
    packed-window gather, so each step costs exactly ONE occ row
    gather (extend_sel_batch) — the round-4 version paid three gathers
    per step (qflat char + occ rows + take_along_axis child select).
    Returns (ck, cl, cs (U, W) post-extension states, ln (U,))."""
    i32 = jnp.int32
    U = k.shape[0]
    ln = jnp.zeros(U, i32)
    alive = valid
    ck, cl, cs = [], [], []
    for j in range(W):                 # static unroll (W is 4..10)
        base = bases[:, j].astype(i32)
        step = alive & (base <= 3)
        cb = jnp.clip(base, 0, 3)
        c = cb if is_back else 3 - cb
        ik = jnp.stack([k, l, s], axis=-1)
        okc = dfm.extend_sel_batch(fm, ik, c, is_back=is_back)  # (U, 3)
        k = jnp.where(step, okc[:, 0], k)
        l = jnp.where(step, okc[:, 1], l)
        s = jnp.where(step, okc[:, 2], s)
        ck.append(k)
        cl.append(l)
        cs.append(s)
        ln = ln + step.astype(i32)
        alive = step
        if stop_s is not None:
            # backward reps stop once the interval drops below the
            # smallest min_hits of their group: every consumer has died
            # by then, and an ln-encoded stop and an s < mh death give
            # identical death position and state-before — so the rep
            # executes EXACTLY the steps of its longest-lived consumer
            # (calls <= queries stays invariant; the forward modes
            # CANNOT stop here: their amb-stop respawn position
            # differs from a small-stop's)
            alive = alive & (s >= stop_s)
    return (jnp.stack(ck, axis=1), jnp.stack(cl, axis=1),
            jnp.stack(cs, axis=1), ln)


def _chain_seg_divs() -> tuple[int, ...]:
    """Lane-width divisors for chain_scan's segmented loop (each
    continuation is n_lanes/d wide).  Env-tunable for the checkin
    sweep; "" disables segmentation."""
    v = os.environ.get("COMPSEED_CHAIN_SEGS", "4,16")
    return tuple(int(x) for x in v.split(",") if x)


def chain_scan(fm: DeviceFMIndex, qarr, rlens, GP: int, memo: dict,
               min_hits=None, pivots0=None, rids=None,
               advance: bool = True, mode: str = "lep",
               min_len: int = 0, max_intv: int = 0,
               record_lane_index: bool = False, active=None,
               W: int = CHAIN_W, u_cap: int | None = None,
               report_rounds: bool = False):
    """Forward scan with a cross-round, cross-mode extension-chain memo
    — the device rendering of the reference's forward SST trie
    (mapping/SST.h:60-92), where a large share of the hits are rounds
    2/3 re-walking content round 1 already paid for.

    The unit of sharing is a CHAIN: W pure forward extensions from a
    bi-interval state, keyed by (l, s, the W upcoming chars packed
    EXACTLY into one uint32 — see packed_windows).  Forward steps rank at l (ops/fm.py:91-95), so (l, s,
    content) determines every l_j/s_j of the chain exactly, while each
    consumer re-bases k by its own offset (dk = lane k0 - entry k0) —
    the l-domain lemma the staged dedup's scatter uses.  Chains carry
    NO stop/push semantics: min_hits (round 2), the greedy round-3
    rule, and the LEP push/stop logic are all evaluated lane-side on
    the gathered states, which is what lets ONE memo serve all three
    seeding rounds (pass the dict returned by round k into round k+1).

    Per while-loop round each live lane probes the memo hash table (one
    gather); misses co-group by the same (l, s, window) key and one
    representative per group walks the chain (u_cap bounds the per-
    round walk width; excess groups just wait a round).  The sweep
    structure — pivot respawns, LEP pushes sorted (rid, pivot, end) —
    is reconstructed lane-side, identically to make_scan.

    Every round runs at the segment's STATIC lane width, so the loop is
    SEGMENTED: it exits as soon as the alive count fits a 4x narrower
    continuation, live lanes are stably compacted (rank scatter), and a
    narrower twin loop continues.  Lanes are only re-indexed — the
    grouping sort's stable tie-break preserves relative order — so the
    pool content, order, stats and memo trajectory are all bit-exact
    vs the unsegmented loop; tail rounds (and round-2's sparse task
    occupancy, which exits segment 1 at round 0) just stop paying full
    width.

    Returns (pool (GP, 7), n_rows, ovf, fq, fc, memo').
    """
    dt = fm.dtype
    i32 = jnp.int32
    R, L = qarr.shape
    n_lanes = R if rids is None else rids.shape[0]
    U = u_cap if u_cap is not None else max(n_lanes // 2, 64)
    U = min(U, n_lanes)
    H = memo["tbl"].shape[0]
    M = memo["cst"].shape[0]
    RCAP = 3 * L + 16

    qflat = qarr.reshape(-1)
    rlens = rlens.astype(i32)
    winflat = packed_windows(qarr, W)
    nxt = next_nonamb(qarr)
    lane_rid0 = jnp.arange(R, dtype=i32) if rids is None \
        else rids.astype(i32)
    lane_rlen0 = rlens[lane_rid0]
    mh0 = jnp.ones(n_lanes, dt) if min_hits is None \
        else jnp.maximum(min_hits.astype(dt), 1)
    row_id0 = jnp.arange(n_lanes, dtype=i32) if record_lane_index \
        else lane_rid0

    p0 = jnp.zeros(n_lanes, i32) if pivots0 is None \
        else pivots0.astype(i32)
    pivot = nxt[lane_rid0, jnp.clip(p0, 0, L - 1)]
    alive = (pivot < lane_rlen0) & (lane_rlen0 > 0)
    if pivots0 is not None:
        alive = alive & (p0 < lane_rlen0)
    if active is not None:
        alive = alive & active

    base0 = qflat[jnp.clip(lane_rid0 * L + pivot, 0, qflat.shape[0] - 1)]
    ik0 = _set_intv(fm, jnp.clip(base0.astype(i32), 0, 3)).T
    big = jnp.iinfo(jnp.int64).max
    jj = jnp.arange(W, dtype=i32)[None, :]

    # the pool is carried as six 1D columns (k,l,s,end,pivot,rid):
    # column scatters are cheaper than a (GP, 7) row scatter per
    # round; validity is synthesized from the cursor at the
    # end (pushes fill slots 0..cursor-1 contiguously).  lane0 maps a
    # (possibly compacted) lane to its original index; the per-lane
    # constants are gathered through it at the top of each round.
    st0 = dict(memo)
    st0.update(
        lane0=jnp.arange(n_lanes, dtype=i32),
        pivot=pivot, pos=pivot + 1, alive=alive,
        k=jnp.where(alive, ik0[:, 0], 0), l=jnp.where(alive, ik0[:, 1], 0),
        s=jnp.where(alive, ik0[:, 2], 0),
        pool_k=jnp.zeros(GP, dt), pool_l=jnp.zeros(GP, dt),
        pool_s=jnp.zeros(GP, dt), pool_e=jnp.zeros(GP, dt),
        pool_p=jnp.zeros(GP, dt), pool_r=jnp.zeros(GP, dt),
        cursor=jnp.asarray(0, i32),
        povf=jnp.asarray(False),
        fq=jnp.asarray(0, i32), fc=jnp.asarray(0, i32),
        rnd=jnp.asarray(0, i32))

    def make_body(w: int, Uw: int):
      def body(st):
        lane0 = st["lane0"]
        lane_rid = lane_rid0[lane0]
        lane_rlen = lane_rlen0[lane0]
        mh = mh0[lane0]
        row_id = row_id0[lane0]
        pivot, pos, lalive = st["pivot"], st["pos"], st["alive"]
        k, l, s = st["k"], st["l"], st["s"]
        pc = jnp.clip(pos, 0, L + 1)
        wv = winflat[lane_rid * (L + 2) + pc]     # exact W-char window

        # ---- probe the memo table (ONE row gather per lane — the
        # whole entry comes back in one (w, 8) fetch).  ALL hit
        # metadata is read here, BEFORE this round's inserts: a slot can
        # be evicted by an insert below, and a hit must apply the entry
        # it matched, not the new occupant.  (The chain STORE rows are
        # append-only, so the ptr gathered here stays valid.)
        slot = _slot_hash(wv, l, s, H)
        wst = _w_store(wv, dt)
        trow = st["tbl"][slot]                              # (w, 8)
        hit = lalive & (trow[:, _T_V] != 0) & (trow[:, _T_W] == wst) & \
            (trow[:, _T_L0] == l) & (trow[:, _T_S0] == s)
        ptr = jnp.clip(trow[:, _T_P], 0, M - 1).astype(i32)
        hk0 = trow[:, _T_K0]
        hln = trow[:, _T_LN].astype(i32)

        # ---- group misses by the same (window, l, s) key.  Sorting by
        # the SLOT (one int32 argsort instead of a 4-key int64 lexsort)
        # brings equal keys adjacent
        # — same key implies same slot — while the boundary test below
        # still compares the FULL key, so a slot collision between
        # distinct keys only splits a group (an extra rep walk), never
        # merges one.
        miss = lalive & ~hit
        order = jnp.argsort(jnp.where(miss, slot, H).astype(i32),
                            stable=True).astype(i32)
        vs = miss[order]
        ko = [x[order] for x in (wv, l, s)]
        diff = jnp.concatenate([
            jnp.asarray([True]),
            jnp.stack([x[1:] != x[:-1] for x in ko]).any(axis=0)])
        head = vs & diff
        gidx_sorted = jnp.cumsum(head, dtype=i32) - 1
        n_u = jnp.sum(head, dtype=i32)
        # compact the group heads' lane indices to the first U rep rows
        # (cumsum rank + 1D scatter; replaces a stable argsort)
        rep_take = jnp.zeros(Uw, i32).at[
            jnp.where(head & (gidx_sorted < Uw), gidx_sorted, Uw)].set(
            order, mode="drop")
        sortpos = jnp.zeros(w, i32).at[order].set(
            jnp.arange(w, dtype=i32))
        group = jnp.clip(gidx_sorted[sortpos], 0, Uw - 1)
        walked = miss & (gidx_sorted[sortpos] < jnp.minimum(n_u, Uw))

        # ---- representatives walk one chain each; their window chars
        # decode from the already-gathered packed key (no char gathers)
        rep_valid = (jnp.arange(Uw, dtype=i32) < jnp.minimum(n_u, Uw)) & \
            miss[rep_take]
        rep_wv = wv[rep_take]
        rep_bases = jnp.stack(
            [(rep_wv >> np.uint32(3 * j)) & np.uint32(7)
             for j in range(W)], axis=1).astype(i32)
        ck, cl, cs, ln = _chain_walk(
            fm, rep_bases, W, k[rep_take], l[rep_take], s[rep_take],
            rep_valid)
        st = dict(st)
        st["fc"] = st["fc"] + jnp.sum(jnp.where(rep_valid, ln, 0),
                                      dtype=i32)

        # ---- insert: chains append to the store (drop when full); the
        # table slot is overwritten whole (newest wins).  Within-round
        # keys are unique (they are the group heads), but two keys can
        # share a SLOT — keep one so the per-field scatters stay
        # mutually consistent (duplicate-index scatter order is
        # undefined, and a slot mixing two entries would corrupt a key).
        # Reps arrive in ascending slot order (the grouping sorted by
        # slot), so duplicate suppression is one adjacent compare.
        rank = jnp.cumsum(rep_valid, dtype=i32) - 1
        cptr = st["cur"] + rank
        can = rep_valid & (cptr < M)
        rslot = slot[rep_take]
        first = jnp.concatenate([jnp.asarray([True]),
                                 rslot[1:] != rslot[:-1]])
        keep = first & can
        tslot = jnp.where(keep, rslot, H)
        cidx = jnp.where(can, cptr, M)
        st["cst"] = st["cst"].at[cidx].set(
            jnp.concatenate([ck, cl, cs], axis=1), mode="drop")
        trows = jnp.stack(
            [_w_store(rep_wv, dt), l[rep_take], s[rep_take],
             k[rep_take], ln.astype(dt), cptr.astype(dt),
             jnp.ones(Uw, dt), jnp.zeros(Uw, dt)], axis=1)
        st["tbl"] = st["tbl"].at[tslot].set(trows, mode="drop")
        st["cur"] = st["cur"] + jnp.sum(can, dtype=i32)

        # ---- apply: every lane consumes its chain (entry or rep walk);
        # the store row comes back in ONE (w, 3W) gather
        memb = walked
        applied = hit | memb
        crow = st["cst"][ptr]

        def pick(lo, wbuf):
            return jnp.where(hit[:, None],
                             crow[:, lo * W:(lo + 1) * W], wbuf[group])

        src_k0 = jnp.where(hit, hk0, k[rep_take][group])
        src_ln = jnp.where(hit, hln, ln[group])
        CK = pick(0, ck) + (k - src_k0)[:, None]
        CL = pick(1, cl)
        CS = pick(2, cs)
        prevk = jnp.concatenate([k[:, None], CK[:, :-1]], axis=1)
        prevl = jnp.concatenate([l[:, None], CL[:, :-1]], axis=1)
        prevs = jnp.concatenate([s[:, None], CS[:, :-1]], axis=1)
        real = jj < src_ln[:, None]
        amb_here = (jj == src_ln[:, None]) & (src_ln[:, None] < W)
        if mode == "r3":
            # bwt_seed_strategy1 (FM_index/bwt.c:358-379): emit the
            # POST-extension interval at the first position where it
            # drops below max_intv at length >= min_len; amb stops
            # without a push; restart past the stop either way
            hitj = real & (CS < jnp.asarray(max_intv, dt)) & \
                ((pos[:, None] + jj - pivot[:, None]) >=
                 jnp.asarray(min_len, i32))
            push = hitj
            stop = hitj | amb_here
            recK, recL, recS = CK, CL, CS
            recE = pos[:, None] + jj + 1
        else:
            changed = CS != prevs
            small = CS < mh[:, None]
            push = (real & changed) | amb_here
            stop = (real & changed & small) | amb_here
            recK, recL, recS = prevk, prevl, prevs
            recE = pos[:, None] + jj
        has_stop = jnp.any(stop, axis=1)
        t = jnp.argmax(stop, axis=1).astype(i32)
        t_eff = jnp.where(has_stop, t, W)
        push = push & (jj <= t_eff[:, None]) & applied[:, None]
        cons = jnp.where(has_stop, t + 1, W)
        st["fq"] = st["fq"] + jnp.sum(jnp.where(applied, cons, 0),
                                      dtype=i32)

        # ---- flush pushes (six 1D column scatters; see st0 comment)
        pflat = push.reshape(-1)
        rank = jnp.cumsum(pflat, dtype=i32) - 1
        pslot = jnp.where(pflat, st["cursor"] + rank, GP)
        st["pool_k"] = st["pool_k"].at[pslot].set(
            recK.reshape(-1), mode="drop")
        st["pool_l"] = st["pool_l"].at[pslot].set(
            recL.reshape(-1), mode="drop")
        st["pool_s"] = st["pool_s"].at[pslot].set(
            recS.reshape(-1), mode="drop")
        st["pool_e"] = st["pool_e"].at[pslot].set(
            recE.reshape(-1).astype(dt), mode="drop")
        st["pool_p"] = st["pool_p"].at[pslot].set(
            jnp.broadcast_to(pivot[:, None], (w, W))
            .reshape(-1).astype(dt), mode="drop")
        st["pool_r"] = st["pool_r"].at[pslot].set(
            jnp.broadcast_to(row_id[:, None], (w, W))
            .reshape(-1).astype(dt), mode="drop")
        st["cursor"] = st["cursor"] + jnp.sum(pflat, dtype=i32)
        st["povf"] = st["povf"] | (st["cursor"] > GP)

        # ---- advance / respawn
        stop_pos = pos + t
        amb_stop = has_stop & (t == src_ln)
        if mode == "r3":
            npv = stop_pos + 1
        else:
            npv = jnp.where(amb_stop, stop_pos + 1, stop_pos)
        newpiv = jnp.where(npv < L,
                           nxt[lane_rid, jnp.clip(npv, 0, L - 1)], L)
        respawn = applied & has_stop & jnp.asarray(advance) & \
            (newpiv < lane_rlen)
        through = applied & ~has_stop                 # mid-sweep, ln == W
        baseN = qflat[jnp.clip(lane_rid * L + newpiv, 0,
                               qflat.shape[0] - 1)]
        ikN = _set_intv(fm, jnp.clip(baseN.astype(i32), 0, 3)).T
        last = jnp.clip(src_ln - 1, 0, W - 1)[:, None]
        endK = jnp.take_along_axis(CK, last, axis=1)[:, 0]
        endL = jnp.take_along_axis(CL, last, axis=1)[:, 0]
        endS = jnp.take_along_axis(CS, last, axis=1)[:, 0]
        st["k"] = jnp.where(respawn, ikN[:, 0],
                            jnp.where(through, endK, k))
        st["l"] = jnp.where(respawn, ikN[:, 1],
                            jnp.where(through, endL, l))
        st["s"] = jnp.where(respawn, ikN[:, 2],
                            jnp.where(through, endS, s))
        st["pivot"] = jnp.where(respawn, newpiv, pivot)
        st["pos"] = jnp.where(respawn, newpiv + 1,
                              jnp.where(through, pos + W, pos))
        st["alive"] = jnp.where(applied, respawn | through, lalive)
        st["rnd"] = st["rnd"] + 1
        return st
      return body

    if report_rounds:
        # profiling diagnostic: per-round alive counts (RCAP-padded)
        st0["alive_hist"] = jnp.zeros(RCAP, jnp.int32)

    def instrument(body_fn):
        def body(st):
            st = dict(st)
            hist = st.pop("alive_hist")
            rnd = st["rnd"]
            hist = hist.at[rnd].set(jnp.sum(st["alive"], dtype=jnp.int32))
            st = body_fn(st)
            st["alive_hist"] = hist
            return st
        return body

    # segment widths: each continuation is 4x narrower, entered once
    # the alive count fits (bit-exact: lanes are only re-indexed)
    segs = [n_lanes]
    for d in _chain_seg_divs():
        w2 = max(n_lanes // d, 256)
        if w2 < segs[-1]:
            segs.append(w2)

    lane_keys = ("lane0", "pivot", "pos", "k", "l", "s")
    st = st0
    for i, w in enumerate(segs):
        nxtw = segs[i + 1] if i + 1 < len(segs) else 0
        body_w = make_body(w, min(U, w))
        if report_rounds:
            body_w = instrument(body_w)

        def cond(st, nxtw=nxtw):
            return (st["rnd"] < RCAP) & \
                (jnp.sum(st["alive"], dtype=i32) > nxtw)

        st = jax.lax.while_loop(cond, body_w, st)
        if nxtw:
            # stable rank-scatter compaction of the live lanes
            lalive = st["alive"]
            crank = jnp.cumsum(lalive, dtype=i32) - 1
            tgt = jnp.where(lalive, crank, nxtw)
            st = dict(st)
            for kk in lane_keys:
                st[kk] = jnp.zeros(nxtw, st[kk].dtype).at[tgt].set(
                    st[kk], mode="drop")
            st["alive"] = jnp.zeros(nxtw, jnp.bool_).at[tgt].set(
                lalive, mode="drop")
    ovf = st["povf"] | jnp.any(st["alive"])

    # pushes fill slots 0..cursor-1 contiguously, so validity is a
    # range test; the (rid, pivot, end) final order packs into one
    # int64 key (bounds are static), replacing a 3-key lexsort
    pvalid = jnp.arange(GP, dtype=i32) < st["cursor"]
    EB = L + 2 * W + 4
    PB = L + 2
    kdt = i32 if (max(R, n_lanes) + 2) * EB * PB < 2**31 else jnp.int64
    okey = (st["pool_r"].astype(kdt) * PB +
            st["pool_p"].astype(kdt)) * EB + st["pool_e"].astype(kdt)
    forder = jnp.argsort(
        jnp.where(pvalid, okey, jnp.iinfo(kdt).max)).astype(i32)
    # permute by SCATTER through the inverse permutation: 1D column
    # scatters instead of one wide (GP, 7) row gather
    rankp = jnp.zeros(GP, i32).at[forder].set(jnp.arange(GP, dtype=i32))
    pool = jnp.stack(
        [jnp.zeros(GP, dt).at[rankp].set(c) for c in
         (st["pool_k"], st["pool_l"], st["pool_s"], st["pool_e"],
          st["pool_p"], st["pool_r"], pvalid.astype(dt))], axis=1)
    memo_out = {kk: st[kk] for kk in MEMO_KEYS}
    if report_rounds:
        return (pool, st["cursor"], ovf, st["fq"], st["fc"], memo_out,
                st["rnd"], st["alive_hist"])
    return pool, st["cursor"], ovf, st["fq"], st["fc"], memo_out


def prefix_hashes(qarr):
    """(R, L) uint8 -> (R, L, 2) uint32 rolling hashes; H[:, i, :]
    covers q[:, :i+1].  A backward walk from position i consumes
    exactly the read prefix below its pivot, so (interval k, size s,
    pivot, prefix-hash) identifies a walk's full outcome across the
    batch — the cross-read state sharing the reference gets from its
    SST trie (mapping/SST.h:60-92), here as a sort/unique over the
    worklist.

    Two independent 32-bit rolling hashes (32-bit words halve the bytes
    of a u64 pair scan).  64 content bits joined with the EXACT
    (k, s, pivot) fields in dedup_pool's boundary compare: a silent
    merge needs two rows with identical interval/size/pivot AND a
    64-bit double collision — < 2e-11 per chunk at pool width 786k,
    i.e. negligible even over genome-scale runs.
    """

    def comb(x, y):
        m1, a1 = x
        m2, a2 = y
        return m1 * m2, a1 * m2 + a2

    def one(base: int, salt: int):
        a = (qarr.astype(jnp.uint32) + jnp.uint32(salt))
        m = jnp.full(qarr.shape, jnp.uint32(base), jnp.uint32)
        _, h = jax.lax.associative_scan(comb, (m, a), axis=1)
        return h

    h1 = one(0x01000193, 1)                  # FNV-32 odd multiplier
    h2 = one(0x9E3779B9, 5)                  # golden-ratio odd multiplier
    return jnp.stack([h1, h2], axis=-1)


def _group_rows(keys, mixes, valid, CAP: int):
    """Group rows by exact key equality; sort by ONE avalanched 32-bit
    mix (cheaper than a multi-key int64 lexsort at pool width) and
    compare every real key at the boundaries: a mix collision only
    splits a group (one duplicate walk), never merges one.

    Returns (rep_take (CAP,) indices of one representative per group,
    group (M,) mapping each row to its group index, n_unique, ovf)."""
    i32 = jnp.int32
    u32 = jnp.uint32
    M = valid.shape[0]
    gh = mixes[0]
    for i, x in enumerate(mixes[1:]):
        gh = (gh ^ (x * u32(0x9E3779B9 + 2 * i))) * u32(0x85EBCA6B)
        gh = gh ^ (gh >> u32(15))
    # invalid rows sort last: 0x7FFFFFFF is int32-max; a valid mix that
    # ties with it only splits a group
    order = jnp.argsort(
        jnp.where(valid, gh >> u32(1), u32(0x7FFFFFFF))
        .astype(i32)).astype(i32)
    ks = [x[order] for x in keys]
    vs = valid[order]
    diff = jnp.concatenate([
        jnp.asarray([True]),
        jnp.stack([x[1:] != x[:-1] for x in ks]).any(axis=0)])
    head = vs & diff
    gidx_sorted = jnp.cumsum(head.astype(i32)) - 1     # group per sortpos
    n_u = jnp.sum(head.astype(i32))
    ovf = n_u > CAP
    rep_take = jnp.zeros(CAP, i32).at[
        jnp.where(head & (gidx_sorted < CAP), gidx_sorted, CAP)].set(
        order, mode="drop")
    sortpos = jnp.zeros(M, i32).at[order].set(
        jnp.arange(M, dtype=i32))
    group = jnp.clip(gidx_sorted[sortpos], 0, CAP - 1)
    return rep_take, group, n_u, ovf


def dedup_pool(pool, ph, CAP_U: int, mh=None):
    """Group pool rows whose walks must be identical; compact one
    representative per group to the front.  mh (per-row min_hits) joins
    the key when walks use varying thresholds (round 2).

    Returns (rep_pool (CAP_U, 7), group (GP,) i32 mapping each row to its
    representative, n_unique, ovf).
    """
    i32 = jnp.int32
    u32 = jnp.uint32
    L = ph.shape[1]
    valid = pool[:, 6] != 0
    rid = pool[:, 5].astype(i32)
    piv = pool[:, 4].astype(i32)
    pcol = jnp.clip(piv - 1, 0, L - 1)
    # flat 1D u32 gathers instead of 2D-indexed u64 gathers
    pidx = rid * L + pcol
    phf = ph.reshape(-1, 2)
    hrow = jnp.where(piv > 0, phf[pidx, 0], u32(0))
    hrow2 = jnp.where(piv > 0, phf[pidx, 1], u32(0))
    keys = [hrow, hrow2, pool[:, 0], pool[:, 2], piv]
    if mh is not None:
        keys.append(mh)
    # 32-bit FOLDS feed the sort mix only; the boundary compare uses
    # the exact native-dtype keys (a fold may not, at int64 scale)
    mixes = [hrow, hrow2,
             (pool[:, 0] ^ (pool[:, 0] >> 31)).astype(u32),
             (pool[:, 2] ^ (pool[:, 2] >> 31)).astype(u32),
             piv.astype(u32)] + \
        ([mh.astype(u32)] if mh is not None else [])
    rep_take, group, n_u, ovf = _group_rows(keys, mixes, valid, CAP_U)
    rep_pool = pool[rep_take]
    rep_valid = (jnp.arange(CAP_U, dtype=i32) < n_u)
    rep_pool = rep_pool.at[:, 6].set(rep_valid.astype(pool.dtype))
    return rep_pool, group, n_u, ovf, rep_take

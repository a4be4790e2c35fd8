"""Measure chain_scan round counts + alive decay on the bench input.

The while-loop round is the cost unit of the memo engine; every round
runs at FULL static lane width regardless of how many lanes are alive.
This prints, for the r1/r2/r3 call shapes, the round count and the
alive-lane decay, to size mid-loop lane compaction (split the loop,
rank-scatter the survivors into a half-width continuation).
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np


def decay(tag, hist, rnd, n_lanes):
    alive = hist[:rnd]
    if not len(alive):
        print(f"{tag}: 0 rounds")
        return
    q = lambda p: int(np.searchsorted(-alive, -p * n_lanes))
    print(f"{tag}: rounds={rnd} start={alive[0]} "
          f"rounds alive>50%={q(0.5)} >25%={q(0.25)} >10%={q(0.10)} "
          f">5%={q(0.05)} >1%={q(0.01)}")
    print(f"{tag} alive[every 2nd]:", alive[::2].tolist())
    print(f"{tag} lane-round utilization: "
          f"{100.0 * alive.sum() / (rnd * n_lanes):.1f}%")


def main():
    import bench
    import jax
    import jax.numpy as jnp
    from compseed.options import MemOptions
    from compseed.ops import seedscan as ss
    from compseed.ops.engine import device_seeder
    from compseed.ops.seeder2 import _bucket, _round_up

    CHUNK = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    fm, reads_arr = bench._setup()
    opt = MemOptions()
    seeder = device_seeder(opt, fm, dedup=True)
    Rb = _bucket(CHUNK, 256)
    Lb = _round_up(101 + 1, 32)
    qa = np.full((Rb, Lb), 4, np.uint8)
    rl = np.zeros(Rb, np.int32)
    for i in range(min(CHUNK, Rb)):
        q = reads_arr[i % len(reads_arr)]
        qa[i, :len(q)] = q
        rl[i] = len(q)
    qd, rd = jnp.asarray(qa), jnp.asarray(rl)
    dfi = seeder.dfi
    dt = dfi.dtype
    i32 = jnp.int32
    GP = seeder.GP_F * Rb
    GP2 = seeder.GP2_F * Rb
    T2 = seeder.T2L_F * Rb
    CW = seeder.chain_w
    MEMO_M = (256 // CW) * Rb
    MEMO_H = 1 << (4 * MEMO_M - 1).bit_length()
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)

    @jax.jit
    def j_r1(fm_, qarr, rlens):
        memo0 = ss.make_chain_memo(MEMO_H, MEMO_M, CW, dt)
        return ss.chain_scan(fm_, qarr, rlens, GP, memo0, W=CW,
                             u_cap=max(Rb // 2, 64), report_rounds=True)

    out = j_r1(dfi, qd, rd)
    pool, cur, ovf, fq, fc, memo, rnd, hist = out
    decay("r1", np.asarray(hist), int(rnd), Rb)
    print(f"r1: fq={int(fq)} fc={int(fc)} n_pool={int(cur)} "
          f"ovf={bool(np.asarray(ovf))}")

    # ---- r2 shape: tasks from a real r1 result
    fns = seeder._build(Rb, Lb)
    r1 = fns["r1"](dfi, qd, rd)
    (pool1, ok, rid, k, l, s, beg, end, *_rest) = r1
    memo1 = r1[-1]

    @jax.jit
    def j_tasks(ok, rid, k, s, beg, end):
        sel = ok & ((end - beg) >= split_len) & (s <= opt.split_width)
        order = jnp.argsort(~sel, stable=True)
        take = order[:T2]
        t_valid = sel[take]
        return (jnp.sum(sel.astype(i32)), t_valid,
                jnp.where(t_valid, rid[take], 0),
                jnp.where(t_valid, (beg[take] + end[take]) // 2, 0),
                jnp.where(t_valid, s[take] + 1, 1))

    n_tasks, t_valid, t_rid, t_mid, t_mh = j_tasks(ok, rid, k, s, beg, end)
    print(f"r2 tasks: {int(n_tasks)} of T2={T2} lanes "
          f"({100.0 * int(n_tasks) / T2:.1f}% occupancy)")

    @jax.jit
    def j_r2(fm_, qarr, rlens, t_valid, t_rid, t_mid, t_mh, memo):
        return ss.chain_scan(fm_, qarr, rlens, GP2, memo, W=CW,
                             u_cap=max(Rb // 4, 64), min_hits=t_mh,
                             pivots0=t_mid.astype(i32),
                             rids=t_rid.astype(i32),
                             advance=False, record_lane_index=True,
                             active=t_valid, report_rounds=True)

    out2 = j_r2(dfi, qd, rd, t_valid, t_rid, t_mid, t_mh, memo1)
    rnd2, hist2 = int(out2[6]), np.asarray(out2[7])
    decay("r2", hist2, rnd2, T2)


if __name__ == "__main__":
    main()

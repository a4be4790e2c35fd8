"""Per-phase device time of the v2 seeder on the bench workload.

Times each jitted seeding program of one chunk (r1 scan + walks, r2
re-seed, r3 greedy, merge, SAL walks + seeds, pack) on its own, each
run ending in block_until_ready, and prints the per-round BWT query and
call volumes.  The chunk is chip_smoke.py's main-phase input (E.
coli-scale genome, 98,304 reordered reads: one -K chunk).  ``--sub``
splits round 1 further.

Usage (on the GPU):  python scripts/profile_phases.py [chunk_reads] [--sub]
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np


def qtime(label, f, *args, reps=3):
    """Compile + warm once, then the best of ``reps`` synchronous runs."""
    import jax
    jax.block_until_ready(f(*args))
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    print(f"{label:34s} {best * 1e3:9.2f} ms", flush=True)
    return best


def main():
    import chip_smoke
    import jax
    import jax.numpy as jnp

    from compseed.device import card_line, require_gpu
    require_gpu("profile_phases")
    print(f"card: {card_line()}", flush=True)
    sub = "--sub" in sys.argv
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    CHUNK = int(args[0]) if args else chip_smoke.MAIN_READS

    # chip_smoke's main-phase input: E. coli-scale genome, 30x reads
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    prefix, reads_path, _ = chip_smoke.main_input()
    from compseed.index.fmindex import FMIndex
    from compseed.pipeline.align import encode_read
    fm = FMIndex.load(prefix)
    with open(reads_path) as f:
        reads_arr = [encode_read(line.strip()) for line in f]
    from compseed.options import MemOptions
    from compseed.ops.engine import device_seeder
    from compseed.ops import seedscan as ss
    from compseed.ops.seeder2 import _bucket, _round_up

    opt = MemOptions()
    seeder = device_seeder(opt, fm, dedup=True)
    R = CHUNK
    Rb = _bucket(R, 256)
    Lb = _round_up(101 + 1, 32)
    qa = np.full((Rb, Lb), 4, np.uint8)
    rl = np.zeros(Rb, np.int32)
    for i in range(R):
        q = reads_arr[i % len(reads_arr)]   # cycle when R > simulated
        qa[i, :len(q)] = q
        rl[i] = len(q)
    fns = seeder._build(Rb, Lb)
    qd, rd = jnp.asarray(qa), jnp.asarray(rl)
    dfi = seeder.dfi

    t_r1 = qtime("r1 scan+walk(+dedup)", fns["r1"], dfi, qd, rd)
    r1 = fns["r1"](dfi, qd, rd)
    (pool, ok, rid, k, l, s, beg, end, ovf1, bad1, n_pool, n_u,
     fqc, fcc, bq1, bc1, memo) = r1
    t_r2 = qtime("r2 reseed", fns["r2"], dfi, qd, rd, ok, rid, k, s,
                 beg, end, memo)
    r2 = fns["r2"](dfi, qd, rd, ok, rid, k, s, beg, end, memo)
    t_r3 = qtime("r3 greedy", fns["r3"], dfi, qd, rd, r2[15])
    r3 = fns["r3"](dfi, qd, rd, r2[15])
    t_mg = qtime("merge/lexsort", fns["merge"], ok, rid, k, l, s, beg,
                 end, *r2[:7], *r3[:7])
    merged = fns["merge"](ok, rid, k, l, s, beg, end, *r2[:7], *r3[:7])
    mok, mrid, mk, ml, ms, mbeg, mend, mtotal, movf = merged
    t_sd = qtime("SAL walks + seeds", fns["seeds"], dfi, mok, mrid, mk,
                 ms, mbeg, mend)
    seeds = fns["seeds"](dfi, mok, mrid, mk, ms, mbeg, mend)
    t_pk = qtime("pack blobs", fns["pack"], mok, mrid, ms, mbeg, mend,
                 merged[7], *seeds[:4], seeds[4], seeds[5], ovf1, r2[7],
                 bad1, r2[8], r3[7], merged[8], seeds[6], r3[8],
                 n_pool, n_u, r2[11], r2[12], bq1, bc1, r2[13], r2[14],
                 fqc, fcc, r2[9], r2[10], r3[9], r3[10])
    total = t_r1 + t_r2 + t_r3 + t_mg + t_sd + t_pk
    print(f"{'TOTAL seeding':34s} {total * 1e3:9.2f} ms "
          f"({CHUNK / total:.0f} reads/s seeding-only)", flush=True)
    fq_t = int(fqc + r2[9] + r3[9])
    fc_t = int(fcc + r2[10] + r3[10])
    print(f"volumes: n_pool={int(n_pool)} n_u={int(n_u)} "
          f"n2={int(r2[11])} n_u2={int(r2[12])} "
          f"mems={int(merged[7])} seeds={int(seeds[3])} "
          f"sal_uniq={int(seeds[4])} fwd_q={fq_t} fwd_c={fc_t}",
          flush=True)
    q_all = int(bq1) + int(r2[13]) + fq_t
    c_all = int(bc1) + int(r2[14]) + fc_t
    print(f"decomp: r1_bwd {int(bq1)}->{int(bc1)} "
          f"(walks {int(n_pool)}->{int(n_u)})  "
          f"r2_bwd {int(r2[13])}->{int(r2[14])} "
          f"(walks {int(r2[11])}->{int(r2[12])})  "
          f"fwd r1 {int(fqc)}->{int(fcc)} r2 {int(r2[9])}->{int(r2[10])} "
          f"r3 {int(r3[9])}->{int(r3[10])}  "
          f"hit% {100.0 * (q_all - c_all) / max(q_all, 1):.2f}",
          flush=True)

    if not sub:
        return

    # ---------------- r1 sub-phases (mirrors j_round1 memo mode) ----
    GP = seeder.GP_F * Rb
    CAP_U = min(seeder.CAPU_F * Rb, GP)
    MAXW = Lb + 2
    stages_u = [(CAP_U, 8), (CAP_U // 2, 16), (CAP_U // 4, 32),
                (CAP_U // 8, 72), (CAP_U // 16, MAXW)]
    CW = seeder.chain_w
    MEMO_M = (256 // CW) * Rb
    MEMO_H = 1 << (4 * MEMO_M - 1).bit_length()
    dt = dfi.dtype

    @jax.jit
    def j_chain(fm_, qarr, rlens):
        memo0 = ss.make_chain_memo(MEMO_H, MEMO_M, CW, dt)
        return ss.chain_scan(fm_, qarr, rlens, GP, memo0, W=CW,
                             u_cap=max(Rb // 2, 64))
    qtime("  r1.chain_scan (fwd memo)", j_chain, dfi, qd, rd)
    pool1, n_pool1, fovf1, fq1, fc1, memo1 = j_chain(dfi, qd, rd)

    @jax.jit
    def j_dedup(qarr, pool_):
        ph = ss.prefix_hashes(qarr)
        return ss.dedup_pool(pool_, ph, CAP_U)
    qtime("  r1.prefix_hash+dedup_pool", j_dedup, qd, pool1)
    rep_pool, group, n_u1, dovf, _ = j_dedup(qd, pool1)

    for n_st in range(1, len(stages_u) + 1):
        stg = stages_u[:n_st]

        def j_walk(fm_, qarr, rp, stg=stg):
            return ss.walk_pool(fm_, qarr.reshape(-1), Lb, rp, stg)
        j_walk = jax.jit(j_walk)
        qtime(f"  r1.walk_pool[:{n_st}] {stg[-1]}", j_walk, dfi, qd,
              rep_pool)

    @jax.jit
    def j_recon(pool_, rp, grp, qarr, fm_):
        death_r, fk_r, fl_r, fs_r, wovf, _calls = ss.walk_pool(
            fm_, qarr.reshape(-1), Lb, rp, stages_u)
        death = death_r[grp]
        fk = fk_r[grp]
        fs = fs_r[grp]
        fl = fl_r[grp] - rp[grp, 1] + pool_[:, 1]
        return ss.reconstruct(pool_, death, fk, fl, fs,
                              opt.min_seed_len, (5, 4))
    # (scatter+reconstruct cost = this minus the full walk above)
    qtime("  r1.walk+scatter+reconstruct", j_recon, pool1, rep_pool,
          group, qd, dfi)

    print(f"r1 volumes: n_pool={int(n_pool1)} n_u={int(n_u1)} "
          f"GP={GP} CAP_U={CAP_U}", flush=True)


if __name__ == "__main__":
    main()

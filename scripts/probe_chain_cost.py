"""A/B the chain_scan memo geometry to locate the per-round cost.

Hypothesis: the while-loop rounds are copy-bound on the memo carry
buffers (H-slot table ~74 MB + (M, W) store ~48 MB at the default
geometry), not compute-bound — per-round real work (lexsort at 16k
lanes, 8-step rep walk at 8k lanes, pool scatter) prices out at ~5 ms
but rounds measure ~21 ms.  If time scales with H+M, it's copies.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np


def qtime(f, *args, n=6, reps=3):
    out = f(*args)
    np.asarray(out[1]).ravel()[:1]
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        r = None
        for _ in range(n):
            r = f(*args)
        np.asarray(r[1]).ravel()[:1]
        dt = (time.perf_counter() - t0 - 0.034) / n
        best = dt if best is None else min(best, dt)
    return best


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
    for i in range(min(CHUNK, len(reads_arr))):
        q = reads_arr[i]
        qa[i, :len(q)] = q
        rl[i] = len(q)
    qd, rd = jnp.asarray(qa), jnp.asarray(rl)
    dfi = seeder.dfi
    dt = dfi.dtype
    GP = seeder.GP_F * Rb
    CW = seeder.chain_w

    def make(MF, HPOW, W=CW, U=None):
        M = MF * Rb
        H = 1 << HPOW

        @jax.jit
        def f(fm_, qarr, rlens):
            memo0 = ss.make_chain_memo(H, M, W, dt)
            p, c, o, fq, fc, m = ss.chain_scan(
                fm_, qarr, rlens, GP, memo0, W=W,
                u_cap=U or max(Rb // 2, 64))
            return p, c, o, fq, fc
        return f

    base = make(256 // CW, (4 * (256 // CW) * Rb - 1).bit_length())
    t = qtime(base, dfi, qd, rd)
    r = base(dfi, qd, rd)
    print(f"baseline  M=32R H=2^21: {t*1e3:7.1f} ms  fq={int(r[3])} "
          f"fc={int(r[4])} ovf={bool(np.asarray(r[2]))}", flush=True)

    for MF, HPOW, label in ((16, 20, "M=16R H=2^20"),
                            (8, 19, "M=8R  H=2^19"),
                            (32, 19, "M=32R H=2^19"),
                            (8, 21, "M=8R  H=2^21")):
        f = make(MF, HPOW)
        t = qtime(f, dfi, qd, rd)
        r = f(dfi, qd, rd)
        print(f"variant {label}: {t*1e3:7.1f} ms  fq={int(r[3])} "
              f"fc={int(r[4])} ovf={bool(np.asarray(r[2]))}", flush=True)


if __name__ == "__main__":
    main()

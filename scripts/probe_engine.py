"""Device time of the banded-SW DP alone: the GPU kernel
(ops/bsw_triton.py) against the XLA program (_extend_core), both band
rounds and the acceptance test, on the same extension pairs.

Pairs are what run_meta_dual hands the DP for 101 bp reads (query class
Q=128, targets up to T=256) and for 2x150 bp reads (Q=256, T=512): each
query is the copy of its target's start with ~1% substitutions and an
occasional short indel, sorted by target length as the runner sorts
them.  Every timing ends in block_until_ready; the two paths must agree
exactly.

Run on the GPU: python scripts/probe_engine.py [P]
The last line of stdout is the whole record as JSON.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np


def make_pairs(rng, P: int, Q: int, T: int, qmin: int, qmax: int, opt,
               max_sc: int = 1):
    """P extension pairs in one query class, sorted by target length, in
    the argument order of bsw.dual_dp: qt (P, Q) int8, qlen, tt (P, T)
    int8, tlen, h0, prev, band round 0, band round 1 ((P,) int32)."""
    from compseed.ops.tiles import clamp_band
    qlen = rng.integers(qmin, qmax + 1, P).astype(np.int32)
    tlen = np.minimum(qlen + rng.integers(40, 101, P), T).astype(np.int32)
    tlen = np.sort(tlen)
    rng.shuffle(qlen)
    qlen = np.minimum(qlen, tlen)
    tt = rng.integers(0, 4, (P, T)).astype(np.int8)
    tt[np.arange(T)[None, :] >= tlen[:, None]] = 4
    qt = np.full((P, Q), 4, np.int8)
    for i in range(P):
        q = tt[i, :qlen[i]].copy()
        sub = rng.random(qlen[i]) < 0.01
        q[sub] = rng.integers(0, 4, int(sub.sum()))
        if rng.random() < 0.05 and qlen[i] > 20:      # a 1-3 bp deletion
            j = int(rng.integers(5, qlen[i] - 5))
            n = int(rng.integers(1, 4))
            q = np.concatenate([q[:j], q[j + n:], tt[i, qlen[i]:qlen[i] + n]])
            q = np.where(q > 3, 0, q)[:qlen[i]]
        qt[i, :len(q)] = q
    h0 = rng.integers(19, 61, P).astype(np.int32)
    prev = np.full(P, -1, np.int32)
    ws = [clamp_band(qlen, w, max_sc, opt.pen_clip5, opt.o_del, opt.e_del,
                     opt.o_ins, opt.e_ins) for w in (opt.w, 2 * opt.w)]
    return qt, qlen, tt, tlen, h0, prev, ws[0], ws[1]


def dual_dp_fn(opt, mat, kernel: bool):
    import jax
    from compseed.ops.bsw import dual_dp
    from compseed.ops.bsw_triton import mat_key
    return jax.jit(lambda *a: dual_dp(
        mat_key(mat), *a, o_del=opt.o_del, e_del=opt.e_del,
        o_ins=opt.o_ins, e_ins=opt.e_ins, zdrop=opt.zdrop, w0=opt.w,
        kernel=kernel))


def timed(f, args, reps: int = 5):
    """Compile + warm once, then reps synchronous runs: (compile_s,
    [ms per run])."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(f(*args))
    first = time.perf_counter() - t0
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ms.append((time.perf_counter() - t0) * 1e3)
    return first, ms


def main():
    import jax
    import jax.numpy as jnp

    from compseed.device import card_line, require_gpu
    from compseed.options import MemOptions
    require_gpu("probe_engine")
    card = card_line()
    P = int(sys.argv[1]) if len(sys.argv) > 1 else 65536
    opt = MemOptions()
    mat = np.array(opt.mat, np.int32)
    rng = np.random.default_rng(5)
    rec = {"card": card, "device_kind": jax.devices()[0].device_kind,
           "P": P, "classes": []}
    for Q, T, qmin, qmax in ((128, 256, 1, 101), (256, 512, 129, 250)):
        host = make_pairs(rng, P, Q, T, qmin, qmax, opt)
        args = [jnp.asarray(a) for a in host]
        row = {"Q": Q, "T": T}
        outs = {}
        for dp in ("kernel", "xla"):
            f = dual_dp_fn(opt, mat, dp == "kernel")
            first, ms = timed(f, args)
            outs[dp] = np.asarray(f(*args))
            row[dp] = {"first_call_s": first, "ms": ms,
                       "median_ms": float(np.median(ms))}
            print(f"[{card}] DP {dp:6s} P={P} Q={Q} T={T}: first call "
                  f"{first:.2f} s, runs {[round(x, 3) for x in ms]} ms",
                  flush=True)
        row["equal"] = bool(np.array_equal(outs["kernel"], outs["xla"]))
        row["round1_pairs"] = int(outs["xla"][:, 6].sum())
        row["speedup"] = row["xla"]["median_ms"] / row["kernel"]["median_ms"]
        print(f"[{card}] Q={Q}: kernel == XLA: {row['equal']}; "
              f"{row['round1_pairs']} pairs took round 1; XLA/kernel "
              f"time {row['speedup']:.2f}x", flush=True)
        rec["classes"].append(row)
    print(json.dumps(rec), flush=True)
    if not all(r["equal"] for r in rec["classes"]):
        sys.exit(1)


if __name__ == "__main__":
    main()

"""Paired-end device bench + full parity vs the reference bwamem.

The PE path (insert-size inference, mate rescue, pair scoring, PE SAM —
compseed_host.cpp pestat/matesw/mem_pair_eq/sam_pe, mirroring
mapping/bwamem_pair.c) has byte-exact goldens on the CPU; this streams simulated proper pairs
through the PRODUCTION device pipeline (device seeder + fused dual
BSW + native PE tail) and byte-compares every record against
`bwamem r1.fq r2.fq` on the same index — the reference's own PE mode
(mem_sam_pe, mapping/bwamem_pair.c:250).  Note the reference CompSeed
binary DECLARES PE unsupported (main.cpp:331-335); this framework
carries the compressive path into PE, so the oracle is bwamem.

Run (GPU): python scripts/pe_bench.py [--pairs 16384] [--runs 3]
Emits one BENCH-style JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

READ_LEN = 101
INS_MEAN, INS_SD = 400, 50


def simulate_pairs(rng, genome, n_pairs):
    """Proper FR pairs at ~30x: fragment ~N(400, 50), R1 forward at the
    fragment start, R2 reverse-complement at the fragment end; same
    error model as bench.py reads.  Pairs are ordered by fragment
    position (layout order)."""
    span = int(n_pairs * 2 * READ_LEN / 30.0)
    base = (len(genome) - span - 800) // 2
    frag0 = rng.integers(base, base + span, size=n_pairs)
    frag0.sort()
    flen = np.clip(rng.normal(INS_MEAN, INS_SD, n_pairs).astype(int),
                   2 * READ_LEN + 10, 700)
    r1 = np.empty((n_pairs, READ_LEN), np.uint8)
    r2 = np.empty((n_pairs, READ_LEN), np.uint8)

    def noisy(r):
        u = rng.random()
        if u < 0.04:
            j = int(rng.integers(10, READ_LEN - 10))
            n = int(rng.integers(1, 5))
            r = np.concatenate([r[:j], r[j + n:]])
        elif u < 0.08:
            j = int(rng.integers(10, READ_LEN - 10))
            n = int(rng.integers(1, 5))
            ins = rng.integers(0, 4, size=n).astype(np.uint8)
            r = np.concatenate([r[:j], ins, r[j:]])
        r = r[:READ_LEN]
        err = rng.random(len(r)) < 0.008
        r[err] = rng.integers(0, 4, size=int(err.sum()))
        return r

    for i in range(n_pairs):
        a = genome[frag0[i]: frag0[i] + READ_LEN + 8].copy()
        b = genome[frag0[i] + flen[i] - READ_LEN - 8:
                   frag0[i] + flen[i]].copy()
        r1[i] = noisy(a)[:READ_LEN]
        bb = noisy(b)[-READ_LEN:]
        bb = bb[::-1].copy()
        m = bb < 4
        bb[m] = 3 - bb[m]
        r2[i] = bb
    return r1, r2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=16384)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--no-parity", action="store_true")
    args = ap.parse_args()

    import bench
    from compseed.io.fastq import Read
    from compseed.options import MEM_F_PE, MemOptions
    from compseed.native import NativeTail
    from compseed.ops.engine import device_engine, device_seeder
    from compseed.pipeline.align import align_stream
    from compseed.pipeline.seeding import SeedingStats
    from compseed.index.fmindex import unpack_pac_range
    from compseed.utils import NT4_TO_ASCII

    fm, _ = bench._setup()
    genome = unpack_pac_range(fm.pac, 0, fm.l_pac)
    rng = np.random.default_rng(77)
    r1, r2 = simulate_pairs(rng, genome, args.pairs)

    opt = MemOptions()
    opt.flag |= MEM_F_PE
    seeder = device_seeder(opt, fm, dedup=True)
    engine = device_engine(opt, fm, dfi=seeder.dfi)
    tail = NativeTail(opt, fm)

    # interleaved chunk: R1_i, R2_i adjacent — the order bwamem
    # processes a two-file PE input in (fastmap.c reads both files in
    # lockstep into one batch)
    reads = []
    for i in range(args.pairs):
        reads.append(Read(name=f"p{i}", seq=bytes(
            NT4_TO_ASCII[r1[i]]).decode(), qual="I" * READ_LEN,
            comment=None))
        reads.append(Read(name=f"p{i}", seq=bytes(
            NT4_TO_ASCII[r2[i]]).decode(), qual="I" * READ_LEN,
            comment=None))

    CHUNK = 16384
    chunks = [reads[s:s + CHUNK] for s in range(0, len(reads), CHUNK)]
    # warmup/compile (paired mode comes from opt.flag & MEM_F_PE)
    align_stream(opt, fm, iter(list(chunks)), engine, seeder, tail,
                 on_done=lambda _: None, stats=SeedingStats())
    rates = []
    for _ in range(args.runs):
        done = []
        t0 = time.time()
        align_stream(opt, fm, iter(list(chunks)), engine, seeder, tail,
                     on_done=done.extend, stats=SeedingStats())
        dt = time.time() - t0
        assert len(done) == len(reads) and all(r.sam for r in done)
        rates.append(len(reads) / dt)

    parity = None
    if not args.no_parity:
        ref_bin = os.path.join(ROOT, ".ref_build", "bwamem")
        prefix = os.path.join(bench.CACHE,
                              f"bench_{bench.GENOME_LEN}_rep_sa8")
        fq1 = os.path.join(bench.CACHE, "pe_r1.fq")
        fq2 = os.path.join(bench.CACHE, "pe_r2.fq")
        with open(fq1, "w") as f1, open(fq2, "w") as f2:
            for i in range(args.pairs):
                f1.write(f"@p{i}\n{reads[2 * i].seq}\n+\n"
                         f"{'I' * READ_LEN}\n")
                f2.write(f"@p{i}\n{reads[2 * i + 1].seq}\n+\n"
                         f"{'I' * READ_LEN}\n")
        out = subprocess.run([ref_bin, prefix, fq1, fq2],
                             capture_output=True, text=True,
                             check=True).stdout
        want = [ln for ln in out.splitlines()
                if ln and not ln.startswith("@")]
        got = []
        for r in done:
            got.extend(r.sam.rstrip("\n").split("\n"))
        bad = sum(1 for a, b in zip(got, want) if a != b)
        bad += abs(len(got) - len(want))
        parity = {"records": len(want), "mismatched": bad}
        print(f"[pe_bench] parity vs bwamem PE: {parity}",
              file=sys.stderr)

    value = float(np.median(rates))
    print(json.dumps({
        "metric": "reads_per_s_per_chip_pe",
        "value": round(value, 2),
        "unit": "reads/s",
        "runs": [round(r, 1) for r in rates],
        "pairs": args.pairs,
        "parity": parity,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Compressor-reordered evidence at scale (>= 1M reads).

The reference's input contract is a read stream reordered by a
reference-free NGS compressor (SPRING/Minicom/PgRC, main.cpp:36-58).
No compressor is installable here (zero egress), so this run uses the
framework's OWN reference-free reorder stage (compseed.io.reorder,
the same minimizer-anchor clustering signal SPRING's reorder stage
uses) on 1M reads drawn in RANDOM sequencing order, then feeds the
identical reordered stream to BOTH the reference CompSeed binary and
this framework, comparing the compressive-health stats (BWT-extend SST
hit %, SAL merged %) and throughput.

Run:  python scripts/compressor_evidence.py [--reads 1000000]
Emits one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

READ_LEN = 101


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--skip-ours", action="store_true",
                    help="only run the reference binary (no device)")
    args = ap.parse_args()

    import bench
    from compseed.utils import NT4_TO_ASCII

    fm, _ = bench._setup()          # the honest 2 Mbp bench index
    prefix = os.path.join(bench.CACHE,
                          f"bench_{bench.GENOME_LEN}_rep_sa8")
    work = os.path.join(bench.CACHE, "compevid")
    os.makedirs(work, exist_ok=True)

    # ---- 1M reads at 30x over a window, RANDOM order (sequencer-like)
    fq_raw = os.path.join(work, f"raw_{args.reads}.fq")
    fq_ro = os.path.join(work, f"reordered_{args.reads}.fq")
    if not os.path.exists(fq_ro):
        rng = np.random.default_rng(99)
        from compseed.index.fmindex import unpack_pac_range
        genome = unpack_pac_range(fm.pac, 0, fm.l_pac)
        span = int(args.reads * READ_LEN / args.coverage)
        span = min(span, len(genome) - READ_LEN - 8)
        base = (len(genome) - span) // 2
        positions = rng.integers(base, base + span - READ_LEN,
                                 size=args.reads)
        # NOT sorted: raw sequencing order
        t0 = time.time()
        with open(fq_raw, "w") as f:
            for i, pos in enumerate(positions):
                r = genome[pos: pos + READ_LEN].copy()
                err = rng.random(READ_LEN) < 0.008
                r[err] = rng.integers(0, 4, size=int(err.sum()))
                if rng.random() < 0.5:
                    r = r[::-1].copy()
                    m = r < 4
                    r[m] = 3 - r[m]
                f.write(f"@r{i}\n{bytes(NT4_TO_ASCII[r]).decode()}\n+\n"
                        f"{'I' * READ_LEN}\n")
        print(f"[evid] {args.reads} raw reads in {time.time()-t0:.0f} s",
              file=sys.stderr)
        # ---- the compressor preprocessing step: our reorder stage.
        # Write via tmp + rename so an interrupted run can't leave a
        # truncated stream that a later run trusts.
        t0 = time.time()
        tmp_ro = fq_ro + ".tmp"
        subprocess.run([sys.executable, "-m", "compseed.cli",
                        "reorder", fq_raw, "-o", tmp_ro],
                       check=True, cwd=ROOT,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
        os.replace(tmp_ro, fq_ro)
        t_reorder = time.time() - t0
        print(f"[evid] reorder: {t_reorder:.0f} s", file=sys.stderr)

    # ---- reference CompSeed on the reordered stream
    ref_bin = os.path.join(ROOT, ".ref_build", "CompSeed")
    if not os.path.exists(ref_bin):
        from scripts.fuzz_parity import ensure_ref_binaries
        ensure_ref_binaries()
    t0 = time.time()
    r = subprocess.run([ref_bin, "-t", "1", prefix, fq_ro],
                       capture_output=True, text=True)
    t_ref = time.time() - t0
    err = r.stderr
    m_hit = re.search(r"BWT-extend:.*?([\d.]+) % hit", err)
    m_sal = re.search(r"SA Lookup:.*?([\d.]+) % merged", err)
    ref_hit = float(m_hit.group(1)) if m_hit else None
    ref_sal = float(m_sal.group(1)) if m_sal else None
    n_sam_ref = sum(1 for ln in r.stdout.splitlines()
                    if ln and not ln.startswith("@"))
    print(f"[evid] reference: {t_ref:.0f} s, hit={ref_hit}% "
          f"sal={ref_sal}% ({n_sam_ref} records)", file=sys.stderr)

    ours = None
    if not args.skip_ours:
        t0 = time.time()
        out_sam = os.path.join(work, "ours.sam")
        # whole-genome ~50x coverage with repeat arrays carries more
        # pool/match volume per read than the 30x windowed bench — cap
        # ratios sized for it, else every chunk takes the (slow) exact
        # legacy fallback
        env = {**os.environ,
               "COMPSEED_GP_F": "54", "COMPSEED_CAPU_F": "36",
               "COMPSEED_T2_F": "12", "COMPSEED_GP2_F": "24",
               "COMPSEED_MEM_F": "16", "COMPSEED_SEED_F": "16",
               "COMPSEED_U_F": "12"}
        p = subprocess.run(
            [sys.executable, "-m", "compseed.cli", "mem",
             "-v", "3", "-K", str(16384 * READ_LEN), "-o", out_sam,
             prefix, fq_ro],
            capture_output=True, text=True, cwd=ROOT, env=env)
        t_ours = time.time() - t0
        oerr = p.stderr
        m_hit2 = re.search(r"BWT-extend:.*?([\d.]+) % hit", oerr)
        m_sal2 = re.search(r"SA Lookup:.*?([\d.]+) % merged", oerr)
        n_sam = 0
        if os.path.exists(out_sam):
            with open(out_sam) as f:
                n_sam = sum(1 for ln in f if not ln.startswith("@"))
        ours = {
            "seconds": round(t_ours, 1),
            "reads_per_s": round(args.reads / t_ours, 1),
            "hit_pct": float(m_hit2.group(1)) if m_hit2 else None,
            "sal_pct": float(m_sal2.group(1)) if m_sal2 else None,
            "sam_records": n_sam,
            "rc": p.returncode,
        }
        print(f"[evid] ours: {ours}", file=sys.stderr)

    print(json.dumps({
        "metric": "compressor_evidence_1M",
        "reads": args.reads,
        "reference": {"seconds": round(t_ref, 1),
                      "reads_per_s": round(args.reads / t_ref, 1),
                      "hit_pct": ref_hit, "sal_pct": ref_sal,
                      "sam_records": n_sam_ref},
        "ours": ours,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

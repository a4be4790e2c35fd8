"""hg19-scale on-device alignment (BASELINE.json config 4).

Loads the 3.1 Gbp index built by scripts/hg19_scale.py into HBM
(int64 index arithmetic, on-disk sa_intv=32, 2-bit packed pac) and
streams simulated 30x layout-ordered reads through the production
pipeline — the first number comparable to the reference's Table 1
whole-genome rows (README.md:82).

Reads are drawn from W windows spread across the genome (a compressed
stream is a sequence of overlap clusters; each window is one cluster
run).  Optionally spot-checks SAM parity by running the reference
bwamem binary on the same reads against the same index files (our
files are byte-identical to bwaidx output, so the reference binary
loads them directly).

Run:  python scripts/hg19_align.py [--workdir /root/hg19_work]
          [--reads 32768] [--windows 8] [--parity 2048]
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
COVERAGE = 30


def simulate_window(rng, genome_w, n_reads):
    """bench.py's read model (subs+indels+N+strand) over one window."""
    span = len(genome_w) - READ_LEN - 8
    positions = rng.integers(0, span, size=n_reads)
    positions.sort()
    reads = np.empty((n_reads, READ_LEN), dtype=np.uint8)
    for i, pos in enumerate(positions):
        r = genome_w[pos: pos + READ_LEN + 8].copy()
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
        err = rng.random(READ_LEN) < 0.008
        r[err] = rng.integers(0, 4, size=int(err.sum()))
        if rng.random() < 0.01:
            r[int(rng.integers(0, READ_LEN))] = 4
        if rng.random() < 0.5:
            r = r[::-1].copy()
            m = r < 4
            r[m] = 3 - r[m]
        reads[i] = r
    return reads


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/root/hg19_work")
    ap.add_argument("--reads", type=int, default=32768)
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument("--parity", type=int, default=-1,
                    help="reads to check vs the bwamem oracle "
                         "(-1 = FULL cohort, 0 disables)")
    ap.add_argument("--sa-intv", type=int, default=0,
                    help="densify the suffix-array sample on device to "
                         "this interval after load (HBM for SAL walk "
                         "depth; the disk index stays intv 32 — the "
                         "2 Mbp bench already runs intv 8)")
    args = ap.parse_args()
    prefix = os.path.join(args.workdir, "mine")
    if not os.path.exists(prefix + ".bwt"):
        print(json.dumps({"metric": "reads_per_s_per_chip_hg19",
                          "value": 0, "unit": "reads/s",
                          "error": "index missing; run hg19_scale.py"}))
        return 1

    from compseed.index.fmindex import FMIndex, unpack_pac_range
    from compseed.io.fastq import Read
    from compseed.options import MemOptions
    from compseed.ops.device_index import to_device
    from compseed.ops.engine import device_engine
    from compseed.ops.seeder2 import DeviceSeeder
    from compseed.pipeline.align import align_stream
    from compseed.pipeline.seeding import SeedingStats
    from compseed.utils import NT4_TO_ASCII

    t0 = time.time()
    fm = FMIndex.load(prefix)
    t_load = time.time() - t0
    print(f"[hg19] index loaded in {t_load:.0f} s "
          f"(l_pac={fm.l_pac:,}, sa_intv={fm.sa_intv})", file=sys.stderr)

    # reads: W layout-ordered windows spread over the forward strand
    rng = np.random.default_rng(42)
    per_w = args.reads // args.windows
    span = int(per_w * READ_LEN / COVERAGE) + READ_LEN + 16
    chunks_nt4 = []
    for w in range(args.windows):
        base = int((w + 0.5) * fm.l_pac / args.windows)
        gw = unpack_pac_range(fm.pac, base, base + span)
        chunks_nt4.append(simulate_window(rng, gw, per_w))
    reads_arr = np.concatenate(chunks_nt4)

    t0 = time.time()
    dfi = to_device(fm)
    import jax
    for leaf in jax.tree_util.tree_leaves(dfi):
        leaf.block_until_ready()
    hbm_gb = sum(leaf.nbytes for leaf in jax.tree_util.tree_leaves(dfi)
                 ) / 1e9
    t_h2d = time.time() - t0
    print(f"[hg19] device index: {hbm_gb:.2f} GB HBM, "
          f"H2D {t_h2d:.0f} s", file=sys.stderr)
    if args.sa_intv and args.sa_intv < fm.sa_intv:
        from compseed.ops.device_index import densify_sa
        t0 = time.time()
        dfi = densify_sa(dfi, args.sa_intv)
        dfi.sa_sampled.block_until_ready()
        fm.sa_intv = args.sa_intv          # keep host/SAL views agreeing
        fm.sa_sampled = np.asarray(dfi.sa_sampled).astype(np.uint64)
        hbm_gb = sum(leaf.nbytes for leaf in
                     jax.tree_util.tree_leaves(dfi)) / 1e9
        print(f"[hg19] SA densified to intv {args.sa_intv} on device in "
              f"{time.time() - t0:.0f} s ({hbm_gb:.2f} GB HBM)",
              file=sys.stderr)

    opt = MemOptions()
    seeder = DeviceSeeder(opt, fm, dfi=dfi, dedup=True)
    engine = device_engine(opt, fm, dfi=dfi)
    from compseed.native import NativeTail
    tail = NativeTail(opt, fm)

    def mk_reads(arr, start):
        # quals match what the parity leg writes into parity.fq — the
        # QUAL column is part of the byte-compare
        return [Read(name=str(start + i), seq=bytes(
            NT4_TO_ASCII[arr[i]]).decode(), qual="I" * READ_LEN,
            comment=None) for i in range(len(arr))]

    CHUNK = args.chunk
    n = (len(reads_arr) // CHUNK) * CHUNK
    all_chunks = [mk_reads(reads_arr[s: s + CHUNK], s)
                  for s in range(0, n, CHUNK)]
    # warmup / compile on the first chunk
    t0 = time.time()
    done = []
    st = SeedingStats()
    align_stream(opt, fm, iter(all_chunks[:1]), engine, seeder, tail,
                 on_done=done.extend, stats=st)
    print(f"[hg19] warmup(+compile) {time.time() - t0:.0f} s",
          file=sys.stderr)
    # timed (steady state: depth-2 pipeline over len(all_chunks));
    # count device-cap fallbacks — the r4 hit% collapse suspect
    fallback_chunks = [0]
    orig_run_flat = seeder.run_flat

    def counting_run_flat(queries, stats=None):
        out = orig_run_flat(queries, stats)
        if seeder.last_overflow:
            fallback_chunks[0] += 1
        return out

    seeder.run_flat = counting_run_flat
    done = []
    st = SeedingStats()
    if tail is not None:
        tail.prof.clear()
    getattr(engine, "prof", {}).clear()
    t0 = time.time()
    align_stream(opt, fm, iter(all_chunks), engine, seeder, tail,
                 on_done=done.extend, stats=st)
    dt = time.time() - t0
    assert len(done) == n and all(r.sam for r in done)
    rate = n / dt
    prof = dict(tail.prof) if tail is not None else {}
    prof.update(getattr(engine, "prof", {}))
    bwt_hit = 100.0 * (st.bwt_queries - st.bwt_calls) / \
        max(st.bwt_queries, 1)
    sal_merged = 100.0 * (st.sal_queries - st.sal_calls) / \
        max(st.sal_queries, 1)

    parity = None
    n_parity = n if args.parity < 0 else min(args.parity, n)
    if n_parity:
        ref_bin = os.path.join(ROOT, ".ref_build", "bwamem")
        if not os.path.exists(ref_bin):
            from scripts.fuzz_parity import ensure_ref_binaries
            ensure_ref_binaries()
        fq = os.path.join(args.workdir, "parity.fq")
        with open(fq, "w") as f:
            for r in done[:n_parity]:
                f.write(f"@{r.name}\n{r.seq}\n+\n{'I' * len(r.seq)}\n")
        out = subprocess.run(
            [ref_bin, prefix, fq], capture_output=True,
            text=True, check=True).stdout
        want = [ln for ln in out.splitlines()
                if ln and not ln.startswith("@")]
        got_by_name = {}
        for r in done[:n_parity]:
            for ln in r.sam.rstrip("\n").split("\n"):
                got_by_name.setdefault(ln.split("\t")[0], []).append(ln)
        want_by_name = {}
        for ln in want:
            want_by_name.setdefault(ln.split("\t")[0], []).append(ln)
        bad = sum(1 for k in want_by_name
                  if got_by_name.get(k) != want_by_name[k])
        parity = {"checked": len(want_by_name), "mismatched": bad}
        print(f"[hg19] parity vs bwamem: {parity}", file=sys.stderr)

    print(json.dumps({
        "metric": "reads_per_s_per_chip_hg19",
        "value": round(rate, 2),
        "unit": "reads/s",
        "genome_bp": int(fm.l_pac),
        "hbm_gb": round(hbm_gb, 2),
        "h2d_s": round(t_h2d, 1),
        "bwt_hit_pct": round(bwt_hit, 2),
        "sal_merged_pct": round(sal_merged, 2),
        "bwt_rounds": st.rounds,
        "fallback_chunks": fallback_chunks[0],
        "dedup_state": {"fwd_disabled": seeder.fwd_disabled,
                        "bwd_disabled": seeder.bwd_disabled,
                        "r2_dedup": seeder.r2_dedup},
        "tail_profile_ms": {k: round(v * 1e3, 1)
                            for k, v in prof.items()},
        "parity": parity,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

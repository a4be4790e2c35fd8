"""hg19-scale index construction proof.

Builds a 3.1 Gbp synthetic genome (24 chromosomes with tandem repeats,
segmental duplications and N holes/telomere gaps — the structural
features that stress a builder) and runs OUR full index build
(native 64-bit SA-IS, csrc/sais.cpp + the chunked packing passes of
index/build.py), recording wall time and peak RSS.  This validates the
"one 64-bit SA-IS subsumes the reference's three BWT builders
(FM_index/is.c <=50 Mbp, bwt_gen.c BWT-SW, rope.c RB2)" design claim at
the scale the reference reserves for BWT-SW (index_main.c:277).

Optionally (--verify, adds hours) also builds with the reference bwaidx
and byte-compares all five index files.

Run:  python scripts/hg19_scale.py [--mbp 3100] [--verify]
Measured 2026-08-17 (this host: 1 CPU core, 125 GB RAM):
  3,100 Mbp (24 chromosomes, 6.2 G suffix positions) built in 5,888 s
  + 194 s write, peak RSS 79.7 GB; outputs .bwt 3.10 GB, .sa 1.55 GB,
  .pac 0.77 GB.  (The reference builds hg19 in ~10 GB RAM but needs
  hours of incremental BWT-SW; ours trades RAM for one linear-time
  pass.)
"""

from __future__ import annotations

import argparse
import os
import resource
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
REF = os.path.join(ROOT, ".ref_build")


def write_genome(path: str, n_mbp: int) -> None:
    from compseed.utils import NT4_TO_ASCII

    rng = np.random.default_rng(1000)
    n_chrom = 24
    per = n_mbp * 1_000_000 // n_chrom
    with open(path, "w") as f:
        for ci in range(n_chrom):
            codes = rng.integers(0, 4, per).astype(np.uint8)
            # centromere-like N gap
            mid = per // 2
            codes[mid: mid + 10_000] = 4
            # alpha-satellite-ish tandem array
            unit = codes[1000: 1171].copy()
            tile = np.tile(unit, 300)
            codes[mid + 20_000: mid + 20_000 + len(tile)] = tile
            # segmental duplication from the previous chromosome region
            src = codes[100_000: 150_000].copy()
            mut = rng.random(len(src)) < 0.02
            src[mut] = rng.integers(0, 4, size=mut.sum())
            codes[per - 200_000: per - 150_000] = src
            s = bytes(NT4_TO_ASCII[codes]).decode().replace("N", "N")
            f.write(f">chr{ci + 1}\n")
            for i in range(0, len(s), 80):
                f.write(s[i: i + 80] + "\n")
            print(f"[hg19_scale] chr{ci + 1} written", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=int, default=3100)
    ap.add_argument("--verify", action="store_true",
                    help="also build with bwaidx and byte-compare")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--blocked", action="store_true",
                    help="low-memory blocked builder (build_index_blocked:"
                         " SA-IS tail + rank-anchored merges, ~18 GB RSS"
                         " at hg19 scale vs ~80 GB in-core)")
    ap.add_argument("--first-block", type=int, default=1 << 30)
    ap.add_argument("--block-size", type=int, default=192 << 20)
    args = ap.parse_args()

    import tempfile
    tmp = args.workdir or tempfile.mkdtemp(prefix="compseed_hg19_")
    os.makedirs(tmp, exist_ok=True)
    fa = os.path.join(tmp, "g.fa")
    if not os.path.exists(fa):
        t0 = time.time()
        write_genome(fa, args.mbp)
        print(f"[hg19_scale] genome: {args.mbp} Mbp in "
              f"{time.time() - t0:.0f} s", flush=True)

    from compseed.index.build import build_index, build_index_blocked
    from compseed.index.io import save_index

    t0 = time.time()
    if args.blocked:
        built = build_index_blocked(fa, first_block=args.first_block,
                                    block_size=args.block_size)
    else:
        built = build_index(fa)
    t_build = time.time() - t0
    save_index(os.path.join(tmp, "mine"), built)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    sizes = {e: os.path.getsize(os.path.join(tmp, "mine" + e)) / 1e9
             for e in (".bwt", ".sa", ".pac")}
    print(f"[hg19_scale] OUR build: {t_build:.0f} s build + "
          f"{time.time() - t0 - t_build:.0f} s write, "
          f"peak RSS {rss:.1f} GB, sizes {sizes}", flush=True)

    if args.verify:
        t0 = time.time()
        subprocess.run([os.path.join(REF, "bwaidx"), "-p",
                        os.path.join(tmp, "ref"), fa], check=True)
        print(f"[hg19_scale] bwaidx (bwtsw): {time.time() - t0:.0f} s",
              flush=True)
        for ext in (".pac", ".ann", ".amb", ".bwt", ".sa"):
            a = open(os.path.join(tmp, "ref" + ext), "rb")
            b = open(os.path.join(tmp, "mine" + ext), "rb")
            while True:
                ca = a.read(1 << 24)
                cb = b.read(1 << 24)
                assert ca == cb, f"{ext} differs"
                if not ca:
                    break
            print(f"[hg19_scale] {ext} byte-identical", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

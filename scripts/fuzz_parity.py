"""Differential fuzzing vs the reference binaries.

Each trial (fully determined by its seed) generates a random genome and
read set with adversarial features (N holes, tandem repeats, shared
segments across contigs, homopolymers, too-short reads, all-N reads,
unmappable reads, indels), builds the index with BOTH bwaidx and our
builder (byte-compared), aligns with the reference `bwamem` binary and
with our production path (device engine on the CPU backend + native
tail), and byte-compares the SAM (minus @PG).

Run:  python scripts/fuzz_parity.py [n_trials] [start_seed]
Failing trials dump artifacts under /tmp/compseed_fuzz/<seed>/.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# fuzzing is a CPU job: it must not hold the GPU
os.environ["JAX_PLATFORMS"] = "cpu"

REF_BUILD = os.path.join(ROOT, ".ref_build")
BWAIDX = os.path.join(REF_BUILD, "bwaidx")
BWAMEM = os.path.join(REF_BUILD, "bwamem")
COMPSEED = os.path.join(REF_BUILD, "CompSeed")
REF_SRC = "/root/reference"
COMP = str.maketrans("ACGTN", "TGCAN")


def ensure_ref_binaries() -> None:
    """Build the reference oracle binaries on demand (cached).

    The differential-fuzz tier is the strongest correctness evidence in
    the suite; it must never silently skip on a fresh checkout.  This
    configures + builds /root/reference into .ref_build the first time
    it is needed (~1 min), and raises loudly if the toolchain or the
    reference tree is unavailable.
    """
    import subprocess
    if all(os.path.exists(p) for p in (BWAIDX, BWAMEM, COMPSEED)):
        return
    if not os.path.isdir(REF_SRC):
        raise RuntimeError(
            f"reference sources not found at {REF_SRC}; cannot build the "
            "differential oracles (bwaidx/bwamem/CompSeed)")
    os.makedirs(REF_BUILD, exist_ok=True)
    cfg = subprocess.run(
        ["cmake", "-DCMAKE_C_FLAGS=-fcommon", "-DCMAKE_CXX_FLAGS=-fcommon",
         REF_SRC, "-G", "Ninja"],
        cwd=REF_BUILD, capture_output=True, text=True)
    if cfg.returncode:
        raise RuntimeError(f"cmake configure of reference oracles failed:\n"
                           f"{cfg.stdout[-2000:]}\n{cfg.stderr[-2000:]}")
    bld = subprocess.run(["ninja"], cwd=REF_BUILD,
                         capture_output=True, text=True)
    if bld.returncode:
        raise RuntimeError(f"ninja build of reference oracles failed:\n"
                           f"{bld.stdout[-2000:]}\n{bld.stderr[-2000:]}")
    missing = [p for p in (BWAIDX, BWAMEM, COMPSEED)
               if not os.path.exists(p)]
    if missing:
        raise RuntimeError(f"reference build completed but binaries "
                           f"missing: {missing}")

# option sets our CLI and the reference getopt both accept verbatim
OPT_POOL = ["-A2", "-B5", "-O5,7", "-E2,1", "-T25", "-k15", "-r1.2",
            "-y10", "-a", "-L3,7", "-w80", "-d80", "-c200", "-D0.4",
            "-T12", "-U9", "-5", "-q", "-M", "-h10", "-s8", "-G80",
            "-W5", "-N2", "-Y", "-xintractg"]


def gen_genome(rng) -> list[str]:
    bases = np.array(list("ACGT"))
    contigs = []
    n_contig = int(rng.integers(1, 4))
    shared = "".join(rng.choice(bases, size=500))  # multi-mapping segment
    for _ in range(n_contig):
        n = int(rng.integers(2000, 30000))
        s = "".join(rng.choice(bases, size=n))
        if rng.random() < 0.7:  # N hole
            p = int(rng.integers(100, n - 100))
            s = s[:p] + "N" * int(rng.integers(1, 30)) + s[p:]
        if rng.random() < 0.5:  # tandem repeat
            p = int(rng.integers(0, len(s) - 200))
            unit = s[p: p + int(rng.integers(20, 120))]
            s = s[:p] + unit * int(rng.integers(3, 9)) + s[p:]
        if rng.random() < 0.4:  # homopolymer run
            p = int(rng.integers(0, len(s)))
            s = s[:p] + "ACGT"[int(rng.integers(0, 4))] * \
                int(rng.integers(30, 120)) + s[p:]
        if rng.random() < 0.5:  # segment shared across contigs
            p = int(rng.integers(0, len(s)))
            s = s[:p] + shared + s[p:]
        contigs.append(s)
    return contigs


def mutate(rng, r: str, err=0.01) -> str:
    rl = list(r)
    for j in range(len(rl)):
        if rng.random() < err:
            rl[j] = "ACGT"[int(rng.integers(0, 4))]
    if rng.random() < 0.08:
        j = int(rng.integers(5, max(6, len(rl) - 5)))
        if rng.random() < 0.5:
            del rl[j: j + int(rng.integers(1, 5))]
        else:
            rl[j:j] = ["ACGT"[int(rng.integers(0, 4))]
                       for _ in range(int(rng.integers(1, 5)))]
    if rng.random() < 0.03:
        rl[int(rng.integers(0, len(rl)))] = "N"
    return "".join(rl)


def gen_reads(rng, contigs, n, read_len) -> list[str]:
    reads = []
    for _ in range(n):
        kind = rng.random()
        if kind < 0.02:   # unmappable garbage
            reads.append("".join(np.random.default_rng(
                int(rng.integers(1 << 30))).choice(
                    np.array(list("ACGT")), size=read_len)))
            continue
        if kind < 0.03:   # all N
            reads.append("N" * read_len)
            continue
        if kind < 0.05:   # too short to seed
            ln = int(rng.integers(5, 18))
        else:
            ln = read_len
        s = contigs[int(rng.integers(0, len(contigs)))]
        if len(s) <= ln:
            continue
        pos = int(rng.integers(0, len(s) - ln))
        r = s[pos: pos + ln]
        if rng.random() < 0.5:
            r = r.translate(COMP)[::-1]
        reads.append(mutate(rng, r))
    return reads


def gen_pairs(rng, contigs, n, read_len):
    pairs = []
    for _ in range(n):
        s = contigs[int(rng.integers(0, len(contigs)))]
        isize = (int(rng.integers(2000, 6000)) if rng.random() < 0.04
                 else int(rng.normal(300, 35)))
        isize = max(read_len + 5, min(isize, len(s) - 5))
        if len(s) <= isize:
            continue
        pos = int(rng.integers(0, len(s) - isize))
        r1 = s[pos: pos + read_len]
        r2 = s[pos + isize - read_len: pos + isize].translate(COMP)[::-1]
        r1, r2 = mutate(rng, r1), mutate(rng, r2)
        if rng.random() < 0.5:
            r1, r2 = (r2.translate(COMP)[::-1], r1.translate(COMP)[::-1])
        pairs.append((r1, r2))
    return pairs


def write_fq(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


def sam_lines(text: str) -> list[str]:
    return [l for l in text.splitlines() if not l.startswith("@PG")]


def run_trial(seed: int, workdir: str, keep: bool = False,
              read_len: int = 101, extra_opts: list[str] | None = None
              ) -> list[str]:
    """Returns a list of mismatch descriptions (empty = pass).

    read_len chooses the jit shape bucket (101 reuses the suite's warm
    bucket; 151+ exercises longer-read shapes at one extra compile).
    extra_opts are appended to the randomly drawn option subset —
    used by CI to force -x preset coverage."""
    from compseed import cli as cs_cli
    from compseed.index import build_index
    from compseed.index.io import save_index

    rng = np.random.default_rng(seed)
    os.makedirs(workdir, exist_ok=True)
    fa = os.path.join(workdir, "g.fa")
    contigs = gen_genome(rng)
    with open(fa, "w") as f:
        for ci, s in enumerate(contigs):
            f.write(f">c{ci}\n")
            for i in range(0, len(s), 70):
                f.write(s[i: i + 70] + "\n")

    errors = []
    # --- index: both builders, byte parity
    pref_ref = os.path.join(workdir, "ref_idx")
    subprocess.run([BWAIDX, "-p", pref_ref, fa], check=True,
                   capture_output=True)
    pref_my = os.path.join(workdir, "my_idx")
    save_index(pref_my, build_index(fa))
    for ext in [".pac", ".ann", ".amb", ".bwt", ".sa"]:
        a = open(pref_ref + ext, "rb").read()
        b = open(pref_my + ext, "rb").read()
        if a != b:
            errors.append(f"index {ext} differs")
    if errors:
        return errors

    # default read_len 101 and read counts <=250: every trial lands in
    # the same (R=256, L=128) jit bucket, so only the first fuzz trial
    # ever pays the (minutes-long, one-CPU-core) cold compile. Length
    # diversity is still exercised via too-short reads and indels.
    paired = rng.random() < 0.35
    opts = list(rng.choice(OPT_POOL, size=int(rng.integers(0, 3)),
                           replace=False))
    if extra_opts:
        # drop random picks that collide with a forced option's flag
        forced_flags = {o[:2] for o in extra_opts}
        opts = [o for o in opts if o[:2] not in forced_flags] + \
            list(extra_opts)
    if paired:
        pairs = gen_pairs(rng, contigs, int(rng.integers(60, 125)), read_len)
        fq1 = os.path.join(workdir, "r1.fq")
        fq2 = os.path.join(workdir, "r2.fq")
        write_fq(fq1, [p[0] for p in pairs])
        write_fq(fq2, [p[1] for p in pairs])
        if rng.random() < 0.3:
            opts.append("-I330,40")
        inputs = [fq1, fq2]
    else:
        reads = gen_reads(rng, contigs, int(rng.integers(80, 250)), read_len)
        if rng.random() < 0.3 and os.path.exists(COMPSEED):
            # compressor-reordered raw input against the CompSeed binary:
            # exercises the reordered reader + the dedup'd seeding path
            fq1 = os.path.join(workdir, "r.reordered")
            with open(fq1, "w") as f:
                for r in sorted(reads):
                    f.write(r + "\n")
        else:
            fq1 = os.path.join(workdir, "r.fq")
            write_fq(fq1, reads)
        inputs = [fq1]

    reordered = inputs[0].endswith(".reordered")
    oracle = COMPSEED if reordered else BWAMEM
    ref = subprocess.run([oracle] + opts + [pref_ref] + inputs,
                         capture_output=True)
    if ref.returncode != 0:
        return [f"bwamem failed rc={ref.returncode}: {ref.stderr[-300:]}"]
    out_my = os.path.join(workdir, "my.sam")
    # our-side-only flags: occasionally run the sharded (mesh) pipeline —
    # the SAM contract is byte-identity across mesh shapes
    my_opts = list(opts)
    import jax
    if len(jax.devices()) >= 2 and rng.random() < 0.25:
        my_opts += ["--mesh", "2"]
    cs_cli.main(["mem"] + my_opts + ["--engine", "device", "-o", out_my,
                pref_ref] + inputs)
    mine = sam_lines(open(out_my).read())
    gold = sam_lines(ref.stdout.decode())
    if mine != gold and reordered:
        # CompSeed's batched-BSW acceptance deviates from BWA-MEM on rare
        # equal-score extension ties; BWA-MEM 0.7.17 is the ground truth
        # (CompSeed README: "same SAM as BWA-MEM"). Accept iff bwamem
        # agrees with us byte-for-byte on the identical read stream.
        fq_eq = os.path.join(workdir, "reordered_as.fq")
        with open(inputs[0]) as f_in, open(fq_eq, "w") as f_out:
            for i, line in enumerate(l for l in f_in if l.strip()):
                s = line.strip()
                f_out.write(f"@{i + 1}\n{s}\n+\n{'I' * len(s)}\n")
        bm = subprocess.run([BWAMEM] + opts + [pref_ref, fq_eq],
                            capture_output=True)

        def mask_qual(lines):  # reordered input carries no qualities
            out = []
            for l in lines:
                if l.startswith("@"):
                    out.append(l)
                    continue
                f = l.split("\t")
                f[10] = "*"
                out.append("\t".join(f))
            return out

        if mask_qual(mine) == mask_qual(sam_lines(bm.stdout.decode())):
            print(f"[fuzz] seed={seed}: CompSeed deviates from bwamem; "
                  "we match bwamem", flush=True)
            gold = mine
    if mine != gold:
        nbad = sum(a != b for a, b in zip(mine, gold)) + \
            abs(len(mine) - len(gold))
        errors.append(f"SAM differs: {nbad} lines (opts={opts} "
                      f"paired={paired} rl={read_len})")
        with open(os.path.join(workdir, "ref.sam"), "w") as f:
            f.write("\n".join(gold) + "\n")
    if not errors and not keep:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    return errors


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    start = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    assert os.path.exists(BWAMEM), "build .ref_build first (see /verify)"
    failures = 0
    for seed in range(start, start + n):
        wd = f"/tmp/compseed_fuzz/{seed}"
        errs = run_trial(seed, wd)
        status = "OK" if not errs else "FAIL " + "; ".join(errs)
        print(f"[fuzz] seed={seed}: {status}", flush=True)
        failures += bool(errs)
    print(f"[fuzz] {n - failures}/{n} trials passed")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()

"""Smoke test of the aligner on one NVIDIA GPU.

Drives the main path a user runs, ``python -m compseed.cli mem --engine
device``, on the card and checks what comes out:

  1. fixture parity — SE, compressor-reordered and PE fixtures against
     the bwamem goldens in tests/fixtures/, byte for byte (minus @PG);
     SE twice, identical both times;
  2. the DP on the card — the banded-SW kernel on P=65,536 extension
     pairs in both query classes against the XLA program and the
     scalar ksw_extend2 oracle (integer DP: tolerance 0);
  3. main path at E. coli K-12 scale (BASELINE.json config 1) — a
     4,641,652 bp synthetic genome indexed with ``cli index``, 98,304
     reordered 101 bp reads at 30x through ``cli mem --engine device``
     (cold and warm), 2,048 sampled records against the oracle engine,
     no whole-chunk fallback.

``--four-cards`` runs only the main-path input through ``--mesh 4`` and
``--mesh 1`` and compares the SAM byte for byte.

Run from the repository root: python chip_smoke.py [--four-cards]
The last line of stdout is one JSON object naming the device; the exit
code is non-zero, with no such line, if there is no GPU or a phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(ROOT, "tests", "fixtures")
WORK = os.path.join(ROOT, ".smoke_work")

ECOLI_LEN = 4_641_652          # E. coli K-12 MG1655 (BASELINE.json config 1)
MAIN_READS = 98_304
DP_PAIRS = 65_536
ORACLE_SAMPLE = 2_048


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def sam_body(path: str) -> list[str]:
    with open(path) as f:
        return [l for l in f if not l.startswith("@PG")]


def records(path: str) -> list[str]:
    with open(path) as f:
        return [l for l in f if not l.startswith("@")]


def mem(args: list[str], out: str) -> tuple[float, str]:
    """One ``cli mem`` run in this process; (wall s, its stderr)."""
    from compseed import cli
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["mem", *args, "-o", out])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"mem {args} exited {rc}:\n{err.getvalue()}")
    return wall, err.getvalue()


def fallbacks(stderr: str) -> tuple[int, int]:
    """(whole-chunk reruns, spliced reads) from the mem report."""
    for line in stderr.splitlines():
        if line.startswith("Fallbacks:"):
            w = line.split()
            return int(w[1]), int(w[4])
    raise RuntimeError("mem printed no fallback counts")


def phase_fixtures(card: str) -> None:
    tiny = os.path.join(FIX, "tiny")
    runs = [("SE", [os.path.join(FIX, "reads.fq")], "golden_bwamem.sam"),
            ("SE again", [os.path.join(FIX, "reads.fq")],
             "golden_bwamem.sam"),
            ("reordered", [os.path.join(FIX, "reads.reordered")],
             "golden_compseed_reordered.sam"),
            ("PE", [os.path.join(FIX, "reads_1.fq"),
                    os.path.join(FIX, "reads_2.fq")],
             "golden_bwamem_pe.sam")]
    outs = {}
    for name, reads, golden in runs:
        out = os.path.join(WORK, f"fixture_{name.replace(' ', '_')}.sam")
        wall, _ = mem([tiny, *reads, "--engine", "device"], out)
        want = sam_body(os.path.join(FIX, golden))
        got = sam_body(out)
        same = got == want
        print(f"[fixtures] [{card}] {name}: {len(got)} lines, "
              f"{'identical to' if same else 'DIFFERS from'} {golden} "
              f"({wall:.1f} s)", flush=True)
        if not same:
            raise AssertionError(f"{name} SAM differs from {golden}")
        outs[name] = got
    if outs["SE"] != outs["SE again"]:     # @PG names the output path
        raise AssertionError("two SE runs gave different bytes")
    print(f"[fixtures] [{card}] two SE runs byte-identical", flush=True)


def phase_dp(card: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from compseed.cpu import ksw
    from compseed.options import MemOptions
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from probe_engine import dual_dp_fn, make_pairs

    opt = MemOptions()
    mat = np.array(opt.mat, np.int32)
    rng = np.random.default_rng(11)
    P = DP_PAIRS
    print(f"[dp] [{card}] tolerance 0: integer DP, no matrix product, "
          "TF32 does not apply", flush=True)
    for Q, T, qmin, qmax in ((128, 256, 1, 101), (256, 512, 129, 250)):
        host = make_pairs(rng, P, Q, T, qmin, qmax, opt)
        args = [jnp.asarray(a) for a in host]
        t0 = time.perf_counter()
        got = np.asarray(jax.block_until_ready(
            dual_dp_fn(opt, mat, True)(*args)))
        t_k = time.perf_counter() - t0
        want = np.asarray(dual_dp_fn(opt, mat, False)(*args))
        n_bad = int((got != want).any(axis=1).sum())
        # scalar oracle on a sample: both rounds + acceptance, as the
        # host flow runs them (comp_seed.cpp:1732-1767)
        qt, ql, tt, tl, h0, prev = host[:6]
        sample = rng.choice(P, 64, replace=False)
        n_bad_o = 0
        for i in sample:
            def ext(w):
                return ksw.extend(int(ql[i]), qt[i, :ql[i]].astype(np.uint8),
                                  int(tl[i]), tt[i, :tl[i]].astype(np.uint8),
                                  mat, opt.o_del, opt.e_del, opt.o_ins,
                                  opt.e_ins, w, opt.pen_clip5, opt.zdrop,
                                  int(h0[i]))
            r = ext(opt.w)
            rnd = 0
            if not (r[0] == prev[i] or r[5] < (opt.w >> 1) + (opt.w >> 2)):
                r, rnd = ext(2 * opt.w), 1
            n_bad_o += tuple(got[i, :7]) != (*r, rnd)
        print(f"[dp] [{card}] P={P} Q={Q} T={T}: kernel vs XLA program "
              f"{n_bad} of {P} pairs differ; vs ksw_extend2 oracle "
              f"{n_bad_o} of {len(sample)} differ (first call incl. "
              f"compile {t_k:.2f} s)", flush=True)
        if n_bad or n_bad_o:
            raise AssertionError("DP kernel disagrees with the reference")


def main_input() -> tuple[str, str, float]:
    """E. coli-scale genome, its index (built by ``cli index``) and the
    reordered reads: (index prefix, reads path, index build s)."""
    import numpy as np

    sys.path.insert(0, ROOT)
    import bench
    from compseed import cli
    from compseed.utils import NT4_TO_ASCII

    prefix = os.path.join(WORK, "ecoli_synth.fa")
    reads_path = os.path.join(WORK, "ecoli_synth.reordered")
    rng = np.random.default_rng(2024)
    genome = bench.make_genome(rng, ECOLI_LEN)
    with open(prefix, "w") as f:
        f.write(">ecoli_synth\n")
        s = bytes(NT4_TO_ASCII[genome]).decode()
        for i in range(0, len(s), 80):
            f.write(s[i: i + 80] + "\n")
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        if cli.main(["index", prefix]) != 0:
            raise RuntimeError("cli index failed")
    t_index = time.perf_counter() - t0
    # the window holds the segmental duplication's source copy, so
    # repeat resolution (XA, MAPQ 0) is on the timed path
    reads = bench.simulate_reads(np.random.default_rng(7), genome,
                                 MAIN_READS, base=int(0.215 * ECOLI_LEN))
    with open(reads_path, "w") as f:
        for r in reads:
            f.write(bytes(NT4_TO_ASCII[r]).decode() + "\n")
    return prefix, reads_path, t_index


def phase_main(card: str) -> None:
    import numpy as np

    from compseed.index.fmindex import FMIndex
    from compseed.io.fastq import read_reordered_chunks
    from compseed.native import NativeTail
    from compseed.options import MemOptions
    from compseed.pipeline.align import align_chunk

    prefix, reads_path, t_index = main_input()
    print(f"[main] [{card}] synthetic E. coli K-12-scale genome "
          f"({ECOLI_LEN} bp) indexed by cli index in {t_index:.1f} s",
          flush=True)
    out = os.path.join(WORK, "main.sam")
    walls = []
    for label in ("cold", "warm"):
        wall, err = mem([prefix, reads_path, "--engine", "device"], out)
        walls.append(wall)
        reruns, spliced = fallbacks(err)
        print(f"[main] [{card}] {label}: {MAIN_READS} reads in "
              f"{wall:.2f} s = {MAIN_READS / wall:.1f} reads/s; "
              f"whole-chunk reruns {reruns}, spliced reads {spliced}",
              flush=True)
        if reruns:
            raise AssertionError("whole-chunk fallback taken")
    got = records(out)
    if len(got) < MAIN_READS:
        raise AssertionError(f"{len(got)} records for {MAIN_READS} reads")

    # oracle engine (what --engine oracle runs: scalar host seeding and
    # extension, native tail) on sampled reads at their own global read
    # index, so hash tie-breaks match; SE records are per read
    fm = FMIndex.load(prefix)
    opt = MemOptions()
    tail = NativeTail(opt, fm)
    reads = [r for c in read_reordered_chunks(reads_path, 1 << 40)
             for r in c]
    by_name = {}
    for line in got:
        by_name.setdefault(line.split("\t", 1)[0], []).append(line)
    sample = np.sort(np.random.default_rng(3).choice(
        len(reads), ORACLE_SAMPLE, replace=False))
    n_bad = 0
    t0 = time.perf_counter()
    for i in sample:
        r = reads[i]
        align_chunk(opt, fm, [r], int(i), tail=tail)
        n_bad += r.sam.splitlines(keepends=True) != by_name[r.name]
    print(f"[main] [{card}] oracle engine on {ORACLE_SAMPLE} sampled "
          f"reads: {n_bad} records differ "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if n_bad:
        raise AssertionError("device SAM differs from the oracle engine")


def phase_four_cards(card: str) -> None:
    prefix, reads_path, _ = main_input()
    outs = []
    for mesh in (4, 1):
        out = os.path.join(WORK, f"mesh{mesh}.sam")
        wall, err = mem([prefix, reads_path, "--engine", "device",
                         "--mesh", str(mesh)], out)
        reruns, spliced = fallbacks(err)
        print(f"[four-cards] [{card}] --mesh {mesh}: {MAIN_READS} reads "
              f"in {wall:.2f} s (incl. compile); whole-chunk reruns "
              f"{reruns}, spliced reads {spliced}", flush=True)
        outs.append(sam_body(out))          # @PG names the output path
    same = outs[0] == outs[1]
    print(f"[four-cards] [{card}] mesh-4 SAM "
          f"{'byte-identical to' if same else 'DIFFERS from'} mesh-1 SAM",
          flush=True)
    if not same:
        raise AssertionError("mesh 4 and mesh 1 SAM differ")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the --mesh 4 vs --mesh 1 comparison")
    args = ap.parse_args(argv)
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's devices: {devices})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from compseed.device import card_line
    card = card_line()
    print(f"card: {card}", flush=True)
    if args.four_cards:
        if len(devices) < 4:
            print(f"chip_smoke: --four-cards needs 4 GPUs, have "
                  f"{len(devices)}", file=sys.stderr)
            return 1
        phases = [("four-cards", phase_four_cards)]
    else:
        phases = [("fixtures", phase_fixtures), ("dp", phase_dp),
                  ("main", phase_main)]
    os.makedirs(WORK, exist_ok=True)
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(card)
        except Exception:
            traceback.print_exc()
            failed.append(name)
        print(f"[{name}] [{card}] {'FAILED' if name in failed else 'ok'} "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serial (non-overlapped) per-chunk wall split: seeding fetch, host
tail phases, device BSW — the numbers align_stream's overlap hides.

Run: python scripts/probe_tail.py [chunk_reads]
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np


def main():
    import bench
    from compseed.io.fastq import Read
    from compseed.options import MemOptions
    from compseed.ops.engine import device_engine, device_seeder
    from compseed.pipeline.align import align_chunk
    from compseed.pipeline.seeding import SeedingStats
    from compseed.native import NativeTail
    from compseed.utils import NT4_TO_ASCII

    CHUNK = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    fm, reads_arr = bench._setup()
    opt = MemOptions()
    seeder = device_seeder(opt, fm, dedup=True)
    engine = device_engine(opt, fm, dfi=seeder.dfi)
    tail = NativeTail(opt, fm)

    def mk_reads(lo, hi):
        return [Read(name=str(i), seq=bytes(
            NT4_TO_ASCII[reads_arr[i % len(reads_arr)]]).decode(),
            qual=None, comment=None) for i in range(lo, hi)]

    # warm both shape buckets
    for s0 in (0, CHUNK):
        align_chunk(opt, fm, mk_reads(s0, s0 + CHUNK), s0,
                    engine=engine, seeder=seeder, tail=tail)
    tail.prof.clear()
    stats = SeedingStats()
    t0 = time.time()
    n = 0
    for rep in range(3):
        for s0 in (0, CHUNK):
            reads = mk_reads(s0, s0 + CHUNK)
            align_chunk(opt, fm, reads, s0, engine=engine,
                        seeder=seeder, tail=tail, stats=stats)
            n += len(reads)
    dt = time.time() - t0
    per_chunk = {k: 1e3 * v / 6 for k, v in tail.prof.items()}
    tail_s = sum(tail.prof.values())
    print(f"serial {n} reads in {dt:.2f} s = {n/dt:.0f} reads/s")
    print(f"per-chunk tail split (ms): "
          f"{ {k: round(v, 1) for k, v in per_chunk.items()} }")
    print(f"seeding+fetch per chunk: {(dt - tail_s) / 6 * 1e3:.0f} ms "
          f"(tail total {tail_s / 6 * 1e3:.0f} ms)")


if __name__ == "__main__":
    main()

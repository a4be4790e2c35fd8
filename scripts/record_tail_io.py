"""Record everything the native tail consumes for one bench chunk —
queries, seeds, and each engine run_flat call's inputs/outputs — so
scripts/replay_tail.py can re-run the tail WITHOUT importing JAX
(needed to put it under AddressSanitizer, which jaxlib's interceptors
cannot survive)."""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import jax
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import bench  # noqa: E402
from compseed.options import MemOptions  # noqa: E402
from compseed.ops.bsw import BswRunner  # noqa: E402
from compseed.pipeline.align import encode_read  # noqa: E402
from compseed.native import NativeTail  # noqa: E402
from compseed.utils import NT4_TO_ASCII  # noqa: E402

CHUNK = int(sys.argv[1]) if len(sys.argv) > 1 else 16384


class RecordingEngine(BswRunner):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.outs = []

    def run_flat(self, qbuf, qoff, rbuf, roff, h0, w, pen_clip):
        out = super().run_flat(qbuf, qoff, rbuf, roff, h0, w, pen_clip)
        self.outs.append(np.stack(out))
        return out


def main() -> None:
    fm, reads_arr = bench._setup()
    opt = MemOptions()
    seeds = np.load("/tmp/seeds_cpu.npz")
    queries = [encode_read(bytes(NT4_TO_ASCII[reads_arr[i]]).decode())
               for i in range(CHUNK)]
    eng = RecordingEngine(opt, np.array(opt.mat))
    tail = NativeTail(opt, fm)
    sams = tail.run_batch_flat(
        queries, seeds["lrep"][:CHUNK], seeds["sflat"], seeds["soff"],
        eng, 0, [str(i) for i in range(CHUNK)], [None] * CHUNK,
        [None] * CHUNK, "", paired=False)
    np.savez("/tmp/tail_replay.npz",
             qarr=np.array(reads_arr[:CHUNK]),
             lrep=seeds["lrep"][:CHUNK], sflat=seeds["sflat"],
             soff=seeds["soff"],
             n_engine_calls=len(eng.outs),
             **{f"eng_out_{i}": o for i, o in enumerate(eng.outs)},
             pac=np.asarray(fm.pac), l_pac=fm.l_pac,
             ann_off=np.array([a.offset for a in fm.bns.anns], np.int64),
             ann_len=np.array([a.length for a in fm.bns.anns], np.int32),
             ann_alt=np.array([a.is_alt for a in fm.bns.anns], np.uint8))
    with open("/tmp/tail_replay_names.txt", "w") as f:
        for a in fm.bns.anns:
            f.write(a.name + "\n")
    with open("/tmp/tail_replay_sams.txt", "w") as f:
        f.writelines(sams)
    print(f"recorded {len(eng.outs)} engine calls, {len(sams)} SAMs")


if __name__ == "__main__":
    main()

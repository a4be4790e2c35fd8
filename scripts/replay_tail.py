"""Replay the native tail from /tmp/tail_replay.npz with a stub engine
returning the recorded BSW outputs.  Imports NO jax — suitable for
AddressSanitizer (build the .so with -fsanitize=address and LD_PRELOAD
libasan).  Verifies the SAM output matches the recording."""
from __future__ import annotations

import os
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import numpy as np

from compseed.options import MemOptions
from compseed.native import NativeTail
from compseed.pipeline.align import encode_read
from compseed.utils import NT4_TO_ASCII

# what matters for ASAN is that jaxlib's native extensions never load
assert "jaxlib" not in sys.modules and \
    "jax._src.xla_bridge" not in sys.modules, "replay must stay jaxlib-free"


class StubEngine:
    def __init__(self, outs):
        self.outs = list(outs)
        self.i = 0

    def run_flat(self, qbuf, qoff, rbuf, roff, h0, w, pen_clip):
        out = self.outs[self.i]
        self.i += 1
        assert out.shape[1] == len(h0), \
            f"call {self.i - 1}: recorded {out.shape[1]} vs live {len(h0)}"
        return tuple(out[j] for j in range(6))


def main() -> None:
    z = np.load("/tmp/tail_replay.npz")
    names = open("/tmp/tail_replay_names.txt").read().split()
    anns = [SimpleNamespace(offset=int(o), length=int(l), is_alt=int(a),
                            name=n)
            for o, l, a, n in zip(z["ann_off"], z["ann_len"],
                                  z["ann_alt"], names)]
    fm = SimpleNamespace(pac=z["pac"], l_pac=int(z["l_pac"]),
                         bns=SimpleNamespace(anns=anns))
    opt = MemOptions()
    qarr = z["qarr"]
    n = len(qarr)
    queries = [encode_read(bytes(NT4_TO_ASCII[qarr[i]]).decode())
               for i in range(n)]
    eng = StubEngine([z[f"eng_out_{i}"]
                      for i in range(int(z["n_engine_calls"]))])
    tail = NativeTail(opt, fm)
    sams = tail.run_batch_flat(
        queries, z["lrep"], z["sflat"], z["soff"], eng, 0,
        [str(i) for i in range(n)], [None] * n, [None] * n, "",
        paired=False)
    want = open("/tmp/tail_replay_sams.txt").read()
    got = "".join(sams)
    print("SAM match:", got == want, " engine calls used:", eng.i)


if __name__ == "__main__":
    main()

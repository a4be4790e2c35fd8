"""Device execution engines pluggable into the pipeline.

``device_engine``  — batched banded-SW extension (ops/bsw.py) with the
                     call signature of pipeline.extension's engine.
``device_seeder``  — batched SMEM seeding + merged SAL (ops/smem.py).
"""

from __future__ import annotations

import numpy as np

from compseed.ops.bsw import BswRunner


def device_engine(opt, fm=None, dfi=None):
    return BswRunner(opt, np.array(opt.mat), dfi=dfi)


def device_seeder(opt, fm, version: str | None = None,
                  dedup: bool = False, dfi=None):
    """v2 (default): device-resident dense-worklist seeder (ops/seeder2);
    v1: lockstep per-read seeder (ops/smem), kept as the fallback path.
    dedup enables cross-read walk dedup for compressor-reordered input.
    dfi: pass a prepared DeviceFMIndex (e.g. one densified with
    ``device_index.densify_sa``) instead of uploading ``fm``."""
    import os
    version = version or os.environ.get("COMPSEED_SEEDER", "v2")
    if version == "v1":
        from compseed.ops.smem import BatchSeeder
        return BatchSeeder(opt, fm, dfi=dfi)
    from compseed.ops.seeder2 import DeviceSeeder
    return DeviceSeeder(opt, fm, dedup=dedup, dfi=dfi)

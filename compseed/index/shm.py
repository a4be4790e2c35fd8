"""Shared-memory index staging (bwalib/bwashm.c equivalent).

The reference stages the ~GB-scale index into POSIX shared memory once
per machine so that every aligner process attaches instead of re-reading
it (bwa_shm_stage, bwashm.c:12-85; bwa_idx_load_from_shm :87-118).  The
equivalent here: the index components are written as .npy files
under /dev/shm and mapped read-only with np.memmap — page-cache-shared
across processes, zero parse cost on attach, and the device upload
(ops.device_index.to_device) reads straight out of the mapping.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

SHM_ROOT = os.environ.get("COMPSEED_SHM_DIR", "/dev/shm/compseed")


def _shm_dir(name: str) -> str:
    return os.path.join(SHM_ROOT, os.path.basename(name))


def shm_stage(prefix: str, name: str | None = None) -> str:
    """Load the on-disk index at ``prefix`` and stage it into shm.

    Returns the shm name (default: basename of prefix)."""
    from compseed.index.fmindex import FMIndex

    fm = FMIndex.load(prefix)
    name = name or os.path.basename(prefix)
    d = _shm_dir(name)
    tmp = d + ".staging"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    np.save(os.path.join(tmp, "bwt_words.npy"), fm.bwt_words)
    np.save(os.path.join(tmp, "cp_occ.npy"), fm.cp_occ)
    np.save(os.path.join(tmp, "sa_sampled.npy"), fm.sa_sampled)
    np.save(os.path.join(tmp, "pac.npy"), fm.pac)
    meta = dict(primary=int(fm.primary), seq_len=int(fm.seq_len),
                sa_intv=int(fm.sa_intv), l_pac=int(fm.l_pac),
                L2=[int(x) for x in fm.L2],
                anns=[dict(name=a.name, anno=a.anno, offset=int(a.offset),
                           length=int(a.length), n_ambs=int(a.n_ambs),
                           gi=int(a.gi), is_alt=int(a.is_alt))
                      for a in fm.bns.anns],
                ambs=[dict(offset=int(a.offset), length=int(a.length),
                           amb=a.amb) for a in fm.bns.ambs],
                bns_seed=int(fm.bns.seed))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    shutil.rmtree(d, ignore_errors=True)
    os.replace(tmp, d)  # atomic publish
    return name


def shm_available(name: str) -> bool:
    return os.path.exists(os.path.join(_shm_dir(name), "meta.json"))


def shm_load(name: str):
    """Attach to a staged index; arrays are read-only memory maps."""
    from compseed.index.build import AmbHole, BntSeq, SeqAnn
    from compseed.index.fmindex import FMIndex

    d = _shm_dir(name)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)

    def mm(fn):
        return np.load(os.path.join(d, fn), mmap_mode="r")

    bns = BntSeq(l_pac=meta["l_pac"], seed=meta["bns_seed"],
                 anns=[SeqAnn(**a) for a in meta["anns"]],
                 ambs=[AmbHole(**a) for a in meta["ambs"]])
    return FMIndex(
        primary=meta["primary"], seq_len=meta["seq_len"],
        sa_intv=meta["sa_intv"],
        L2=np.array(meta["L2"], dtype=np.uint64),
        bwt_words=mm("bwt_words.npy"), cp_occ=mm("cp_occ.npy"),
        sa_sampled=mm("sa_sampled.npy"), pac=mm("pac.npy"), bns=bns)


def shm_destroy(name: str | None = None) -> None:
    """Remove one staged index, or everything (bwa shm -d semantics)."""
    if name is None:
        shutil.rmtree(SHM_ROOT, ignore_errors=True)
    else:
        shutil.rmtree(_shm_dir(name), ignore_errors=True)

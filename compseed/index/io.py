"""BWA-compatible index file IO (.pac/.ann/.amb/.bwt/.sa).

Byte-level contracts:
  .bwt — primary(u64) L2[1..4](u64 x4) then the Occ-interleaved BWT: per
         128-base block, 4 u64 checkpoint counts followed by up to 8 u32
         words of 2-bit BWT, and one trailing checkpoint
         (bwt_dump_bwt FM_index/bwt.c:385-394, layout macros bwt.h:73-80,
         bwt_bwtupdate_core FM_index/index_main.c:152-174).
  .sa  — primary, L2[1..4], sa_intv(u64), seq_len(u64), sa[1:]
         (bwt_dump_sa FM_index/bwt.c:396-407).
  .pac — packed forward reference + terminator bytes
         (bns_fasta2bntseq FM_index/bntseq.c:314-327).
  .ann/.amb — text metadata (bns_dump FM_index/bntseq.c:65-95).
"""

from __future__ import annotations

import os

import numpy as np

from compseed.index.build import (
    OCC_INTERVAL, AmbHole, BntSeq, BuiltIndex, SeqAnn,
)


def _interleave_bwt(seq_len: int, bwt_words: np.ndarray, cp_occ: np.ndarray) -> np.ndarray:
    """Merge packed BWT words and checkpoints into the on-disk layout."""
    n_data_blocks = (seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
    n_words_total = (seq_len + 15) >> 4
    cp_u32 = cp_occ.astype("<u8").view("<u4").reshape(-1, 8)
    out = np.empty(n_words_total + (n_data_blocks + 1) * 8, dtype=np.uint32)
    k = 0
    for b in range(n_data_blocks):
        out[k: k + 8] = cp_u32[b]
        k += 8
        w0 = b * 8
        w1 = min(w0 + 8, n_words_total)
        out[k: k + (w1 - w0)] = bwt_words[w0:w1]
        k += w1 - w0
    out[k: k + 8] = cp_u32[n_data_blocks]
    k += 8
    assert k == len(out)
    return out


def _deinterleave_bwt(seq_len: int, interleaved: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split the on-disk layout back into (bwt_words, cp_occ)."""
    n_data_blocks = (seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
    n_words_total = (seq_len + 15) >> 4
    bwt_words = np.empty(n_words_total, dtype=np.uint32)
    cp_u32 = np.empty((n_data_blocks + 1, 8), dtype=np.uint32)
    k = 0
    for b in range(n_data_blocks):
        cp_u32[b] = interleaved[k: k + 8]
        k += 8
        w0 = b * 8
        w1 = min(w0 + 8, n_words_total)
        bwt_words[w0:w1] = interleaved[k: k + (w1 - w0)]
        k += w1 - w0
    cp_u32[n_data_blocks] = interleaved[k: k + 8]
    cp_occ = cp_u32.view("<u8").reshape(-1, 4).astype(np.uint64)
    return bwt_words, cp_occ


def write_bwt(path: str, primary: int, L2: np.ndarray, seq_len: int,
              bwt_words: np.ndarray, cp_occ: np.ndarray) -> None:
    header = np.array([primary, L2[1], L2[2], L2[3], L2[4]], dtype="<u8")
    body = _interleave_bwt(seq_len, bwt_words, cp_occ)
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(body.astype("<u4").tobytes())


def read_bwt(path: str) -> tuple[int, np.ndarray, int, np.ndarray, np.ndarray]:
    """Returns (primary, L2, seq_len, bwt_words, cp_occ)."""
    with open(path, "rb") as f:
        raw = f.read()
    header = np.frombuffer(raw[:40], dtype="<u8")
    primary = int(header[0])
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = header[1:].astype(np.int64)
    seq_len = int(L2[4])
    interleaved = np.frombuffer(raw[40:], dtype="<u4")
    bwt_words, cp_occ = _deinterleave_bwt(seq_len, interleaved)
    return primary, L2, seq_len, bwt_words, cp_occ


def write_sa(path: str, primary: int, L2: np.ndarray, sa_intv: int,
             seq_len: int, sa_sampled: np.ndarray) -> None:
    header = np.array([primary, L2[1], L2[2], L2[3], L2[4], sa_intv, seq_len],
                      dtype="<u8")
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(sa_sampled[1:].astype("<u8").tobytes())


def read_sa(path: str, primary: int, seq_len: int) -> tuple[int, np.ndarray]:
    with open(path, "rb") as f:
        raw = f.read()
    header = np.frombuffer(raw[:56], dtype="<u8")
    if int(header[0]) != primary:
        raise ValueError("SA-BWT inconsistency: primary mismatch")
    if int(header[6]) != seq_len:
        raise ValueError("SA-BWT inconsistency: seq_len mismatch")
    sa_intv = int(header[5])
    n_sa = (seq_len + sa_intv) // sa_intv
    sa = np.empty(n_sa, dtype=np.uint64)
    sa[0] = np.uint64(0xFFFFFFFFFFFFFFFF)
    sa[1:] = np.frombuffer(raw[56:], dtype="<u8", count=n_sa - 1)
    return sa_intv, sa


def write_pac(path: str, pac: np.ndarray, l_pac: int) -> None:
    with open(path, "wb") as f:
        f.write(pac[: (l_pac >> 2) + (0 if l_pac % 4 == 0 else 1)].tobytes())
        if l_pac % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([l_pac % 4]))


def read_pac(path: str) -> tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        raw = f.read()
    rem = raw[-1]
    l_pac = (len(raw) - 2) * 4 + rem
    pac = np.frombuffer(raw, dtype=np.uint8)[: (l_pac + 3) // 4].copy()
    return pac, l_pac


def write_ann_amb(prefix: str, bns: BntSeq) -> None:
    with open(prefix + ".ann", "w") as f:
        f.write(f"{bns.l_pac} {bns.n_seqs} {bns.seed}\n")
        for p in bns.anns:
            f.write(f"{p.gi} {p.name}")
            f.write(f" {p.anno}\n" if p.anno else "\n")
            f.write(f"{p.offset} {p.length} {p.n_ambs}\n")
    with open(prefix + ".amb", "w") as f:
        f.write(f"{bns.l_pac} {bns.n_seqs} {bns.n_holes}\n")
        for h in bns.ambs:
            f.write(f"{h.offset} {h.length} {h.amb}\n")


def read_ann_amb(prefix: str) -> BntSeq:
    with open(prefix + ".ann") as f:
        toks = f.read().split("\n")
    first = toks[0].split()
    bns = BntSeq(l_pac=int(first[0]), seed=int(first[2]))
    n_seqs = int(first[1])
    li = 1
    for _ in range(n_seqs):
        head = toks[li].split(None, 2)
        gi = int(head[0]); name = head[1]
        anno = head[2] if len(head) > 2 else ""
        if anno == "(null)":
            anno_store = "(null)"
        else:
            anno_store = anno
        nums = toks[li + 1].split()
        bns.anns.append(SeqAnn(name=name, anno=anno_store, offset=int(nums[0]),
                               length=int(nums[1]), n_ambs=int(nums[2]), gi=gi))
        li += 2
    with open(prefix + ".amb") as f:
        lines = f.read().split("\n")
    first = lines[0].split()
    if int(first[0]) != bns.l_pac or int(first[1]) != n_seqs:
        raise ValueError("inconsistent .ann and .amb files")
    for i in range(int(first[2])):
        o, l, a = lines[1 + i].split()
        bns.ambs.append(AmbHole(int(o), int(l), a))
    # optional .alt file marks ALT contigs (bns_restore, bntseq.c:178-209)
    alt_path = prefix + ".alt"
    if os.path.exists(alt_path):
        names = {p.name: p for p in bns.anns}
        with open(alt_path) as f:
            for line in f:
                tok = line.split("\t", 1)[0].split("\n")[0].strip()
                if tok and not tok.startswith("@") and tok in names:
                    names[tok].is_alt = 1
    return bns


def save_index(prefix: str, built: BuiltIndex) -> None:
    bwt_words_flat = _pack_words_from_codes(built)
    write_bwt(prefix + ".bwt", built.primary, built.L2, built.seq_len,
              bwt_words_flat, built.cp_occ)
    write_sa(prefix + ".sa", built.primary, built.L2, built.sa_intv,
             built.seq_len, built.sa_sampled)
    write_pac(prefix + ".pac", built.pac, built.bns.l_pac)
    write_ann_amb(prefix, built.bns)


def _pack_words_from_codes(built: BuiltIndex) -> np.ndarray:
    from compseed.index.build import pack_bwt_words
    return pack_bwt_words(built.bwt_codes)

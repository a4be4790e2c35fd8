"""Device-resident FM-index.

Device-memory layout (a redesign of the bwt_t blob, FM_index/bwt.h:48-60):
one occ query = ONE row gather.  Each 128-base block is a fused 48-byte
row of 12 uint32 words:

  words 0-3   checkpoint counts of A/C/G/T up to the block start (the
              per-base counts of even hg19 fit uint32)
  words 4-7   "hi" bitplane — bit b of word w is the high bit of the
              2-bit code at block position w*32 + b
  words 8-11  "lo" bitplane — low bits, same layout

In-block ranks are masked popcounts over the planes (the 64-bit
occ_aux4 trick of FM_index/bwt.c:98-105, widened to vector lanes).
Random row gathers are the bottleneck of every FM operation, so halving
gathers (no separate checkpoint fetch) and shrinking rows from 144 B to
48 B beats the expanded-byte layout.

  * ``occ_rows``   (n_blocks+1, 12) uint32 — fused occ/BWT rows
  * ``sa_sampled`` (n_sa,)          — sampled suffix array
  * ``pac_words``  (ceil(l_pac/16),) uint32 — forward reference kept
    2-bit packed, 16 bases per word (the reference keeps pac packed for
    exactly this reason, FM_index/bwt.h:36-39: an unpacked uint8 copy
    would cost 3.1 GB of HBM at hg19 vs 0.78 GB packed, on top of the
    ~2.3 GB occ rows).  ``pac_codes_at`` extracts codes per position.

Counts/positions compute in int32 when they fit (seq_len + 1 < 2^31),
else int64 (``dtype``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from compseed.index.build import OCC_INTERVAL
from compseed.index.fmindex import FMIndex


@partial(jax.tree_util.register_dataclass,
         data_fields=["occ_rows", "sa_sampled", "L2", "pac_words"],
         meta_fields=["primary", "seq_len", "sa_intv", "l_pac", "idx_dtype"])
@dataclass(frozen=True)
class DeviceFMIndex:
    occ_rows: jax.Array    # (n_blocks+1, 12) uint32
    sa_sampled: jax.Array  # (n_sa,) idx_dtype
    L2: jax.Array          # (5,) idx_dtype
    pac_words: jax.Array   # (ceil(l_pac/16),) uint32, 2-bit packed
    primary: int
    seq_len: int
    sa_intv: int
    l_pac: int
    idx_dtype: np.dtype

    @property
    def dtype(self):
        return jnp.int32 if self.idx_dtype == np.int32 else jnp.int64


def expand_bwt_codes(bwt_words: np.ndarray) -> np.ndarray:
    """(n_blocks, 8) packed uint32 -> (n_blocks, 128) uint8 codes."""
    n_blocks = bwt_words.shape[0]
    shifts = np.array([(15 - j) << 1 for j in range(16)], dtype=np.uint32)
    expanded = (bwt_words[:, :, None] >> shifts[None, None, :]) & 3
    return expanded.reshape(n_blocks, 128).astype(np.uint8)


def build_occ_rows(cp_occ: np.ndarray, bwt_words: np.ndarray) -> np.ndarray:
    """Fuse checkpoints + BWT bitplanes into (n_blocks+1, 12) uint32."""
    n_blocks = bwt_words.shape[0]
    codes = expand_bwt_codes(bwt_words)              # (n_blocks, 128)
    hi = (codes >> 1).astype(np.uint32)
    lo = (codes & 1).astype(np.uint32)
    bit = (np.arange(128, dtype=np.uint32) & 31)
    hi_w = np.zeros((n_blocks, 4), np.uint32)
    lo_w = np.zeros((n_blocks, 4), np.uint32)
    for w in range(4):
        cols = slice(w * 32, (w + 1) * 32)
        hi_w[:, w] = (hi[:, cols] << bit[cols]).sum(axis=1, dtype=np.uint32)
        lo_w[:, w] = (lo[:, cols] << bit[cols]).sum(axis=1, dtype=np.uint32)
    rows = np.zeros((cp_occ.shape[0], 12), np.uint32)
    rows[:, 0:4] = cp_occ.astype(np.uint32)
    rows[:n_blocks, 4:8] = hi_w
    rows[:n_blocks, 8:12] = lo_w
    return rows


def pack_pac_words(pac: np.ndarray, l_pac: int) -> np.ndarray:
    """View the on-disk 2-bit pac (4 bases/byte, first base in the high
    bits — _set_pac, FM_index/bntseq.c:229) as little-endian uint32
    words of 16 bases each, padded to a whole word."""
    nb = (l_pac + 3) // 4
    pad = (-nb) % 4
    b = np.ascontiguousarray(pac[:nb])
    if pad:
        b = np.concatenate([b, np.zeros(pad, dtype=np.uint8)])
    return np.frombuffer(b.tobytes(), dtype="<u4")


def pac_codes_at(pac_words: jax.Array, pos: jax.Array) -> jax.Array:
    """Extract 2-bit base codes at flat forward positions.

    pos is clipped into the packed range; out-of-range reads are
    garbage codes the callers mask (same contract as the old unpacked
    gather).  Base i lives in word i>>4, byte (i>>2)&3 (LE), bits
    (3-(i&3))*2 within the byte.
    """
    n = pac_words.shape[0]
    p = jnp.clip(pos, 0, n * 16 - 1)
    w = pac_words[(p >> 4).astype(jnp.int32)]   # word count always < 2^31
    sh = (8 * ((p >> 2) & 3) + 2 * (3 - (p & 3))).astype(jnp.uint32)
    return ((w >> sh) & 3).astype(jnp.uint8)


def densify_sa(dfi: DeviceFMIndex, new_intv: int,
               chunk: int = 1 << 21) -> DeviceFMIndex:
    """Resample the suffix array to a DENSER interval on device.

    The reference ships `.sa` at intv 32 (FM_index/bwt.c:218 via bwtsw);
    a denser sample is a pure HBM-for-walk-depth trade this framework
    exposes (bench.py builds intv 8 directly; this retrofits a loaded
    intv-32 index, e.g. hg19, without touching the on-disk files).

    Each new sample SA[j*new_intv] is computed by the same masked
    inverse-Psi walk SAL uses (`sa_batch`), batched ``chunk`` lanes at a
    time.  The walked values are EXACTLY the directly-built denser
    sample, including the -1 sentinel at [0]: a walk that passes the
    primary row picks up SA[primary]=0 via invPsi(primary)=0 and then
    terminates at row 0 adding the stored -1 — the same wrap arithmetic
    bwt_cal_sa/bwt_sa rely on (FM_index/bwt.c:86-96), so sums telescope
    identically (differential test: tests/test_ops_fm.py).
    """
    old = dfi.sa_intv
    assert new_intv < old and old % new_intv == 0 and \
        new_intv & (new_intv - 1) == 0, (old, new_intv)
    import dataclasses

    n_new = dfi.seq_len // new_intv + 1
    from compseed.ops.fm import sa_batch
    jf = jax.jit(sa_batch)
    parts = []
    for s in range(0, n_new, chunk):
        n = min(chunk, n_new - s)
        # fixed-width program: pad the tail chunk with k=0 lanes
        # (already sampled -> zero-step walks)
        k = np.zeros(chunk, dtype=np.int64)
        k[:n] = (np.arange(s, s + n, dtype=np.int64) * new_intv)
        out = np.asarray(jf(dfi, jnp.asarray(k.astype(dfi.idx_dtype))))
        parts.append(out[:n])
    sa_new = jnp.asarray(np.concatenate(parts))
    return dataclasses.replace(dfi, sa_sampled=sa_new, sa_intv=new_intv)


def to_device(fm: FMIndex, force_dtype=None) -> DeviceFMIndex:
    """force_dtype overrides the int32/int64 choice (testing the
    hg19-scale int64 path on small genomes)."""
    idx_dtype = force_dtype or (
        np.int32 if fm.seq_len + 1 < 2**31 else np.int64)
    assert fm.cp_occ.max() < 2**32, "per-base counts exceed uint32"
    rows = build_occ_rows(fm.cp_occ, fm.bwt_words)
    return DeviceFMIndex(
        occ_rows=jnp.asarray(rows),
        sa_sampled=jnp.asarray(fm.sa_sampled.astype(idx_dtype)),
        L2=jnp.asarray(fm.L2.astype(idx_dtype)),
        pac_words=jnp.asarray(pack_pac_words(fm.pac, fm.l_pac)),
        primary=fm.primary,
        seq_len=fm.seq_len,
        sa_intv=fm.sa_intv,
        l_pac=fm.l_pac,
        idx_dtype=idx_dtype,
    )

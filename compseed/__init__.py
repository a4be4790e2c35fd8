"""compseed — a GPU compressive short-read alignment engine in JAX.

A from-scratch JAX/XLA/Pallas implementation of compressive alignment in the
spirit of CompSeed (reference: /root/reference, i-xiaohu/CompSeed): BWA-MEM
v0.7.17-compatible FM-index SMEM seeding that exploits the redundancy of
compressor-reordered read batches, followed by banded Smith-Waterman
extension, emitting SAM records that match BWA-MEM 0.7.17.

Architecture (device-first, not a port):

  * ``compseed.index``    — FM-index construction + BWA-compatible on-disk
    formats (.pac/.ann/.amb/.bwt/.sa).  Reference contract:
    FM_index/bntseq.c, FM_index/bwt.c, FM_index/index_main.c.
  * ``compseed.ops``      — batched device kernels: occ/rank gathers,
    bidirectional extension, SA lookup (inverse-Psi walk), SMEM seeding and
    the banded-SW extension DP.  All fixed-shape, jit/scan/vmap programs, with
    a Pallas (Triton) kernel for the DP on the GPU.  Reference contract: FM_index/bwt.c, bwalib/ksw.c,
    mapping/bandedSWA.cpp.
  * ``compseed.cpu``      — scalar oracle implementations used by the
    differential test-suite (the reference's own correctness methodology).
  * ``compseed.pipeline`` — the alignment pipeline: compressive seeding,
    chaining/filtering, cross-read batched extension, dedup/mapq/SAM.
    Reference contract: mapping/comp_seed.cpp.
  * ``compseed.parallel`` — device-mesh data parallelism (pjit/shard_map).
"""

__version__ = "0.1.0"

from compseed.options import MemOptions  # noqa: F401

"""Device kernels: batched FM-index queries, SMEM seeding, banded SW.

Everything here is fixed-shape jax (jit/vmap/scan), with a Pallas kernel
for the banded-SW DP on the GPU.  int64 support is enabled for large
genomes (the hg19 forward+reverse index has 2*l_pac > 2^32 positions);
small genomes use int32 throughout (DeviceFMIndex.idx_dtype).
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the fused seeding/DP programs take tens
# of seconds to compile on first use.  JAX_COMPILATION_CACHE_DIR, when
# set, places it (JAX reads the variable itself); otherwise it lives at a
# fixed path in the checkout, since the path is part of the cache key.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

"""Device-side reference window fetch.

bns_get_seq semantics (FM_index/bntseq.c:403-424) for windows that lie
entirely on one strand: forward windows are direct gathers from the
2-bit-expanded pac; reverse-strand windows mirror and complement.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from compseed.ops.device_index import DeviceFMIndex, pac_codes_at


def fetch_windows(fm: DeviceFMIndex, beg: jax.Array, width: int) -> jax.Array:
    """Fetch (N, width) base codes starting at beg (forward-reverse coords).

    Windows must not bridge the strand boundary; positions outside
    [0, 2*l_pac) read as 4 handled by caller masks.
    """
    l_pac = fm.l_pac
    offs = jnp.arange(width, dtype=beg.dtype)
    pos = beg[:, None] + offs[None, :]
    is_rev = beg >= l_pac
    # mirror reverse-strand coordinates into forward space
    pos_f = jnp.where(is_rev[:, None], 2 * l_pac - 1 - pos, pos)
    bases = pac_codes_at(fm.pac_words, pos_f)
    return jnp.where(is_rev[:, None], 3 - bases, bases)

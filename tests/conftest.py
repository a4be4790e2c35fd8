import os

# Tests run on a virtual multi-device CPU platform; the GPU path is
# exercised by chip_smoke.py on the card.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

from compseed.index.build import BuiltIndex, build_index
from compseed.index.fmindex import FMIndex

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="session")
def tiny_built() -> BuiltIndex:
    return build_index(os.path.join(FIXTURES, "tiny.fa"))


@pytest.fixture(scope="session")
def tiny_fm(tiny_built) -> FMIndex:
    return FMIndex.from_built(tiny_built)


@pytest.fixture(scope="session")
def micro():
    """A very small random genome + its index, for brute-force comparisons."""
    rng = np.random.default_rng(3)
    seq = rng.integers(0, 4, size=1500).astype(np.uint8)
    return _index_from_codes(seq)


def _index_from_codes(seq: np.ndarray):
    import tempfile
    from compseed.utils import NT4_TO_ASCII
    with tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False) as f:
        f.write(">micro\n")
        f.write(bytes(NT4_TO_ASCII[seq]).decode() + "\n")
        path = f.name
    built = build_index(path)
    fm = FMIndex.from_built(built)
    os.unlink(path)
    return seq, built, fm

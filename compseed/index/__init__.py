from compseed.index.fmindex import FMIndex  # noqa: F401
from compseed.index.build import build_index  # noqa: F401

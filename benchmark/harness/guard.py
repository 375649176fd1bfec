"""Which modules a run may not load. The JAX package's name is a prefix of
the port's (rtsdm_tpu, rtsdm_tpu_torch), so names are compared whole, by
the part before the first dot."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "rtsdm_tpu"})
PROGRAM = "rtsdm_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None, forbidden=FORBIDDEN) -> list[str]:
    """The sorted top-level names in `modules` (default sys.modules) that
    are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & set(forbidden))

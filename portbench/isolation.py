"""The run's isolation from the JAX package: no module whose top-level
name (the part before the first dot) is one of FORBIDDEN may be loaded
in the process that prints the result.  Names compare whole, so the
port, `mrcnn3d_torch`, is not the JAX package `mrcnn3d`."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "mrcnn3d")


def forbidden_loaded(modules=None):
    """The forbidden top-level names among `modules` (sys.modules)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))

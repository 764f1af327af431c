"""Nothing of JAX runs in the measured process.

Modules are compared by their top-level name, the part before the first dot,
whole: `classpp_public_torch` is the port and begins with the JAX package's
name without being it.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "classpp_public_tpu")


def loaded(forbidden=FORBIDDEN, modules=None) -> list:
    """The loaded modules whose top-level name is one of `forbidden`."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in forbidden)

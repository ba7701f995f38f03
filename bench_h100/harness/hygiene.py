"""No run may load JAX or the JAX package: the names are compared whole, by
the top-level name of each module (the part before the first dot), so
``hipad_torch`` is never taken for ``hipad_tpu``."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hipad_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))

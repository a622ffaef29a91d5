"""The import guard: no module of JAX or of the JAX package may be loaded
in a process that measures the port.  Names are compared by their
top-level package, whole: ``textreid_torch`` passes, ``textreid_tpu``
does not."""

from __future__ import annotations

import sys
from typing import Iterable, List

BANNED = frozenset({"jax", "jaxlib", "flax", "textreid_tpu"})


def banned_modules(names: Iterable[str] = None) -> List[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in BANNED)


def check(where: str) -> None:
    """Exit with code 4, naming what was found on standard error, when a
    banned module is loaded."""
    found = banned_modules()
    if found:
        print(f"import guard ({where}): loaded {', '.join(found[:20])}",
              file=sys.stderr)
        raise SystemExit(4)

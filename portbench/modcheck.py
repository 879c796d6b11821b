"""The check that nothing the run loaded is JAX or the JAX package.

Modules are compared by their whole top-level name (the part before the
first dot): ``theanet_tpu_torch`` is the port and passes, ``theanet_tpu``
is the JAX package and fails."""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "theanet_tpu"})


def forbidden_modules(modules):
    """The sorted top-level names among ``modules`` (e.g. ``sys.modules``)
    that are JAX, jaxlib, flax or the JAX package."""
    return sorted({name.split(".", 1)[0] for name in modules}
                  & FORBIDDEN)

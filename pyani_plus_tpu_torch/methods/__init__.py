"""The port's method registry: the methods ported so far.

``ComputeContext`` and ``run_pairwise`` carry no JAX and are the JAX
package's own (imported, not copied), so a ported method drives pairs,
ticks progress and flushes exactly as the reference does.
"""

from __future__ import annotations

import importlib
from typing import Any

from pyani_plus_tpu.methods import ComputeContext, run_pairwise

__all__ = ["ComputeContext", "get_method", "method_names", "run_pairwise"]

# Method name (as stored in configurations) -> module of this package.
_MODULES = {
    "ANIm": "anim",
    "dnadiff": "dnadiff",
    "ANIb": "anib",
    "sourmash": "sourmash",
}


def method_names() -> list[str]:
    return list(_MODULES)


def get_method(name: str) -> Any:
    try:
        modname = _MODULES[name]
    except KeyError:
        msg = (
            f"Method {name!r} is not ported to PyTorch yet; ported: "
            f"{sorted(_MODULES)} (the JAX package runs the others)"
        )
        raise ValueError(msg) from None
    return importlib.import_module(f"pyani_plus_tpu_torch.methods.{modname}")

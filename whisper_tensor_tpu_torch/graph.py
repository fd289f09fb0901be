"""Graph backbone: identity scheme + uniform introspection protocol.

Equivalent of the reference's src/graph.rs:18-24,104+ (GlobalId + the
Node/Link/Graph/Property traits every IR implements so the UI can
introspect any layer uniformly). Here: process-unique integer ids and a
``properties()`` protocol returning plain JSON-able dicts.

The port's copy of whisper_tensor_tpu/graph.py, unchanged
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict

_counter = itertools.count(1)
_lock = threading.Lock()


def new_global_id() -> int:
    """Process-unique id for graphs/nodes/links (UI identity)."""
    with _lock:
        return next(_counter)


class Introspectable:
    """Uniform UI-introspection protocol (reference Node/Property traits)."""

    def display_name(self) -> str:
        return type(self).__name__

    def properties(self) -> Dict[str, Any]:
        """JSON-able op parameters for inspection UIs."""
        out = {}
        for k, v in vars(self).items():
            if k.startswith("_"):
                continue
            if isinstance(v, (int, float, str, bool, type(None))):
                out[k] = v
            elif isinstance(v, (list, tuple)) and all(
                isinstance(x, (int, float, str, bool, type(None))) for x in v
            ):
                out[k] = list(v)
            else:
                out[k] = repr(v)
        return out

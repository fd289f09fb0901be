"""Symbolic scalars and the symbol resolver.

Equivalent of the reference's SymbolicScalarTyped / SymbolicResolver
(src/symbolic_scalar.rs:7,116): a symbolic value is an affine expression
``symbol + offset`` over an opaque symbol id allocated by a resolver.
Named ONNX dim_params (e.g. "seq_len") map to stable symbols so that
equal names compare equal across tensors — which is what lets the XLA
backend bucket a whole graph on one concrete binding per symbol.

The port's copy of whisper_tensor_tpu/symbolic.py, unchanged
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class SymbolicScalar:
    """Affine symbolic value: symbol(symbol_id) + offset."""

    symbol_id: int
    offset: int = 0
    name: Optional[str] = None  # originating dim_param, if any (debug/UI)

    def __add__(self, k: int) -> "SymbolicScalar":
        return SymbolicScalar(self.symbol_id, self.offset + int(k), self.name)

    def __sub__(self, k: int) -> "SymbolicScalar":
        return self + (-int(k))

    def same_symbol(self, other: "SymbolicScalar") -> bool:
        return self.symbol_id == other.symbol_id

    def __repr__(self) -> str:
        base = self.name or f"s{self.symbol_id}"
        if self.offset == 0:
            return f"?{base}"
        return f"?{base}{self.offset:+d}"


class SymbolicResolver:
    """Allocates fresh symbols; interns named symbols (ONNX dim_param)."""

    def __init__(self) -> None:
        self._counter = itertools.count()
        self._named: Dict[str, SymbolicScalar] = {}

    def new_symbol(self, name: Optional[str] = None) -> SymbolicScalar:
        if name is not None:
            if name not in self._named:
                self._named[name] = SymbolicScalar(next(self._counter), 0, name)
            return self._named[name]
        return SymbolicScalar(next(self._counter), 0, None)

    def named_symbols(self) -> Dict[str, SymbolicScalar]:
        return dict(self._named)

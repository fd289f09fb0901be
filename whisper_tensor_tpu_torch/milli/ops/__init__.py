"""Importing this package registers every lowering the port has; the
filled table is LOWERINGS."""

from .. import transforms  # noqa: F401  (QuantMatMul)
from ..registry import LOWERINGS
from . import attention, basic, index, misc, norm, shape  # noqa: F401

__all__ = ["LOWERINGS"]

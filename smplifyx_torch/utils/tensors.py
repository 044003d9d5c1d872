"""Dataclasses of tensors: the port's counterpart of flax pytrees."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


class TensorFields:
    """Mixin for dataclasses whose tensor fields move and map together.

    Fields that are TensorFields themselves map with them; other
    non-tensor fields (static metadata such as parent tuples) are kept as
    they are.
    """

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        """A copy with fn applied to every tensor field."""
        out = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if isinstance(value, torch.Tensor):
                out[f.name] = fn(value)
            elif isinstance(value, TensorFields):
                out[f.name] = value.map(fn)
        return dataclasses.replace(self, **out)

    def to(self, device):
        return self.map(lambda t: t.to(device))

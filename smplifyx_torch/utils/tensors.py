"""Dataclasses of tensors: the port's counterpart of flax pytrees."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


class TensorFields:
    """Mixin for dataclasses whose tensor fields move and map together.

    Non-tensor fields (static metadata such as parent tuples) are kept as
    they are.
    """

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        """A copy with fn applied to every tensor field."""
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })

    def to(self, device):
        return self.map(lambda t: t.to(device))

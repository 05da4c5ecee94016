"""Structural cache keys and a small LRU used by the trace launchers.

Counterpart of ``pygenray_tpu/utils/cache.py``.  PyTorch runs eagerly, so
there is no compiled executable to memoize; what the kernel launcher caches
is its per-launch set-up (constants and host-precomputed step flags), which
depends only on an environment's *structure* — its static metadata plus
tensor shapes, dtypes and device — never on the tensor values.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

__all__ = ["env_struct_key", "LRUCache"]


def env_struct_key(env):
    """Hashable structural identity of an ``EnvData``: its static metadata
    plus (shape, dtype, device) of every tensor field."""
    key = []
    for f in dataclasses.fields(env):
        v = getattr(env, f.name)
        if isinstance(v, torch.Tensor):
            key.append((f.name, tuple(v.shape), str(v.dtype), str(v.device)))
        else:
            key.append((f.name, v))
    return tuple(key)


class LRUCache:
    """Bounded mapping that evicts only the least-recently-used entry
    (a full ``clear()`` on overflow would drop live entries too)."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._data = OrderedDict()

    def get(self, key):
        try:
            self._data.move_to_end(key)
            return self._data[key]
        except KeyError:
            return None

    def put(self, key, value):
        self._data[key] = value
        self._data.move_to_end(key)
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)

    def __len__(self):
        return len(self._data)

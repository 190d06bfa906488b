"""Multi-prefix snapshot store, longest-prefix reuse under a byte-budget
LRU: port of `kivi_tpu/serving/prefix_cache.py`.

`Engine.prefill_prefix` gives one shared prefix; a serving tier holds
many (system prompts per tenant, multi-turn conversation heads) and
reuses partial overlaps.  This store keeps `PrefixSnapshot`s keyed by
their token ids and answers "a snapshot for exactly these tokens" three
ways, cheapest first:

  * exact hit: the stored snapshot (every reader copies it, none writes
    it);
  * extend hit: the longest stored strict prefix grown by the remaining
    tokens through `Engine.extend` (the tail attends the quantized
    prefix, as chunked prefill does);
  * miss: a full `prefill_prefix` (exact attention).

Eviction is least-recently-used under a device-byte budget; the 2/4-bit
stores are what make holding many prefixes affordable
(`snapshot_bytes`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from kivi_tpu_torch.serving.engine import Engine, PrefixSnapshot


def snapshot_bytes(snap: PrefixSnapshot) -> int:
    """Device bytes held by a snapshot: every tensor of its caches (packed
    stores, scales, fp windows) and its token ids, as the JAX function
    counts leaves."""
    n = snap.tokens.nbytes
    for c in snap.caches:
        for f in dataclasses.fields(c):
            x = getattr(c, f.name)
            if isinstance(x, torch.Tensor):
                n += x.nbytes
    return int(n)


class PrefixCache:
    """LRU store of prefilled prompt prefixes for one Engine.

    max_bytes: device-byte budget over the stored snapshots (None:
    unbounded).  A single snapshot larger than the budget is returned but
    not stored."""

    def __init__(self, engine: Engine, max_bytes: Optional[int] = None):
        self.engine = engine
        self.max_bytes = max_bytes
        self._store: dict[tuple, PrefixSnapshot] = {}
        self._last_use: dict[tuple, int] = {}
        self._clock = 0
        self.hits = self.extends = self.misses = self.evictions = 0

    def __len__(self) -> int:
        return len(self._store)

    @property
    def nbytes(self) -> int:
        return sum(snapshot_bytes(s) for s in self._store.values())

    @staticmethod
    def _key(tokens) -> tuple:
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.cpu().numpy()
        return tuple(int(t) for t in np.asarray(tokens).reshape(-1))

    def lookup(self, tokens) -> Tuple[Optional[PrefixSnapshot], int]:
        """The longest stored snapshot whose tokens prefix `tokens` (the
        query itself counts): (snapshot or None, matched length).  Moves
        neither the LRU clock nor the counters."""
        key = self._key(tokens)
        best, blen = None, 0
        for k, snap in self._store.items():
            n = len(k)
            if blen < n <= len(key) and key[:n] == k:
                best, blen = snap, n
        return best, blen

    def get(self, tokens) -> PrefixSnapshot:
        """A snapshot of exactly `tokens`, reusing the longest stored
        prefix (module docstring); stored (within the budget) and marked
        most recently used."""
        key = self._key(tokens)
        if not key:
            raise ValueError("empty prefix")
        snap, n = self.lookup(key)
        if n == len(key):
            self.hits += 1
        elif snap is not None:
            self.extends += 1
            self._touch(self._key(snap.tokens))   # the base stays warm
            snap = self.engine.extend(snap, list(key[n:]))
        else:
            self.misses += 1
            snap = self.engine.prefill_prefix(list(key))
        self._insert(key, snap)
        return snap

    def put(self, snap: PrefixSnapshot) -> None:
        """Store a snapshot built elsewhere (load_prefix_snapshot after a
        restart)."""
        self._insert(self._key(snap.tokens), snap)

    def _touch(self, key: tuple) -> None:
        if key in self._store:
            self._clock += 1
            self._last_use[key] = self._clock

    def _insert(self, key: tuple, snap: PrefixSnapshot) -> None:
        self._store[key] = snap
        self._touch(key)
        if self.max_bytes is None:
            return
        while self.nbytes > self.max_bytes and len(self._store) > 1:
            victim = min((k for k in self._store if k != key),
                         key=self._last_use.__getitem__)
            del self._store[victim], self._last_use[victim]
            self.evictions += 1
        if self.nbytes > self.max_bytes:      # a lone oversized snapshot
            self._store.pop(key, None)
            self._last_use.pop(key, None)

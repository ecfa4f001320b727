"""Where an entry point runs: on the card unless the caller asks for the CPU;
and the caches of the tables that device code reads."""

from __future__ import annotations

import contextlib
import functools

import torch


def row(table: torch.Tensor, i) -> torch.Tensor:
    """table[i] for an int i, or for a 0-d integer tensor i on the table's
    device, gathered there: indexing with a 0-d tensor reads it on the host
    (a sync, which a CUDA graph's capture rejects)."""
    if isinstance(i, torch.Tensor):
        return table.index_select(0, i.reshape(1).to(torch.int64))[0]
    return table[i]


def resolve(device, who: str) -> torch.device:
    """torch.device(device); raises for a CUDA device where there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device (pass device='cpu' to run on the CPU)")
    return device


# one dict per warm-up in progress (`recording`): (cache, key) -> each table
# handed out
_RECORDS = []
# one (held, made) per capture in progress (`holding`): held, id -> each table
# handed out; made, the record of the warm-up before it
_HOLDERS = []


def table_cache(maxsize: int):
    """functools.lru_cache(maxsize) for a function that returns tables on a
    device.  A CUDA graph reads its tables by address at every replay, so an
    evicted table that a live graph read would be freed under it: each table
    this cache hands out while a graph captures (inside `holding`) is held
    by that graph as well, and lives as long as the graph.

    The rule for a capture: it may read any table that the warm-up just
    before it handed out.  The warm-up runs inside `recording`, which keeps
    every table this cache returns there under its key; a capture that
    misses the LRU (the warm-up asked for more keys than `maxsize` and
    evicted its own first tables) takes the table from that record, so no
    bound limits how many tables one step reads.  A key that the warm-up
    never asked for, and the LRU does not hold, raises: its table would be
    made while the graph captures, and a copy from the host cannot be
    captured."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args, **kw):
            key = (get, args, tuple(kw.items()))
            if not _HOLDERS:
                out = cached(*args, **kw)
                for made in _RECORDS:
                    made[key] = out
                return out
            out = _HOLDERS[-1][1].get(key)
            if out is None:
                misses = cached.cache_info().misses
                out = cached(*args, **kw)
                if cached.cache_info().misses != misses:
                    raise RuntimeError(f"{fn.__qualname__}: a table made while a graph captures "
                                       f"(a key its warm-up did not ask for)")
            for held, _ in _HOLDERS:
                held[id(out)] = out
            return out

        get.cache_info, get.cache_clear = cached.cache_info, cached.cache_clear
        get.cache_parameters = cached.cache_parameters
        return get
    return wrap


def _pop(stack, item):
    stack.pop(next(i for i, x in enumerate(stack) if x is item))


@contextlib.contextmanager
def recording():
    """Yields a dict that gets every table a `table_cache` hands out inside
    the block, by cache and key (a warm-up keeps it for its capture)."""
    made = {}
    _RECORDS.append(made)
    try:
        yield made
    finally:
        _pop(_RECORDS, made)


@contextlib.contextmanager
def holding(made=None):
    """Yields a dict that gets every table a `table_cache` hands out inside
    the block (a graph's capture keeps it).  A lookup that misses a cache's
    LRU takes the table from `made`, the record of the warm-up before the
    capture (`recording`), and raises where that has none."""
    entry = ({}, {} if made is None else made)
    _HOLDERS.append(entry)
    try:
        yield entry[0]
    finally:
        _pop(_HOLDERS, entry)

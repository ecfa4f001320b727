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


# one dict per capture in progress (`holding`): id -> each table handed out
_HOLDERS = []


def table_cache(maxsize: int):
    """functools.lru_cache(maxsize) for a function that returns tables on a
    device.  A CUDA graph reads its tables by address at every replay, so an
    evicted table that a live graph read would be freed under it: each table
    this cache hands out while a graph captures (inside `holding`) is held
    by that graph as well, and lives as long as the graph.  A capture
    follows a warm-up on the same arguments, so a table made while a graph
    captures means one step asks for more keys than `maxsize`: it raises
    (a copy from the host cannot be captured)."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args, **kw):
            if not _HOLDERS:
                return cached(*args, **kw)
            misses = cached.cache_info().misses
            out = cached(*args, **kw)
            if cached.cache_info().misses != misses:
                raise RuntimeError(f"{fn.__qualname__}: a table made while a graph captures "
                                   f"(one step asks for more than {maxsize} keys)")
            for held in _HOLDERS:
                held[id(out)] = out
            return out

        get.cache_info, get.cache_clear = cached.cache_info, cached.cache_clear
        get.cache_parameters = cached.cache_parameters
        return get
    return wrap


@contextlib.contextmanager
def holding():
    """Yields a dict that gets every table a `table_cache` hands out inside
    the block (a graph's capture keeps it)."""
    held = {}
    _HOLDERS.append(held)
    try:
        yield held
    finally:
        _HOLDERS.pop(next(i for i, h in enumerate(_HOLDERS) if h is held))

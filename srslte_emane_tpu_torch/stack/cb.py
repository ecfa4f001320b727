"""Picklable callback: replaces closure lambdas in the layer wiring so whole
network snapshots serialize (runtime/checkpoint.py)."""

from __future__ import annotations


class Cb:
    """Cb(obj, "method", *pre) -> callable(sdu) == obj.method(*pre, sdu)."""

    __slots__ = ("obj", "method", "pre")

    def __init__(self, obj, method: str, *pre):
        self.obj = obj
        self.method = method
        self.pre = pre

    def __call__(self, *args):
        return getattr(self.obj, self.method)(*self.pre, *args)

    def __getstate__(self):
        return (self.obj, self.method, self.pre)

    def __setstate__(self, s):
        self.obj, self.method, self.pre = s

"""Restricted pickle deserialization for the TCP transports.

The reference exchanges protobuf / fixed C structs between processes
(SURVEY.md §8), which cannot execute code on decode.  The python transports
here (apps/rpc.py, runtime/distrib.py) use pickle for convenience; to keep
the same no-code-execution property, `safe_loads` only resolves classes from
an allowlist: this package's own modules (dataclass schemas), numpy array
reconstruction, and a small set of harmless builtins.  Anything else —
`os.system`, `subprocess.Popen`, arbitrary `__reduce__` gadgets — raises
`pickle.UnpicklingError` instead of importing attacker-chosen callables.
"""

from __future__ import annotations

import builtins
import io
import pickle

_SAFE_BUILTINS = {
    "complex", "frozenset", "set", "bytearray", "range", "slice",
}

# numpy's pickle protocol entry points (no code execution on decode)
_SAFE_NUMPY = {
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "builtins" and name in _SAFE_BUILTINS:
            return getattr(builtins, name)
        if (module, name) in _SAFE_NUMPY:
            return super().find_class(module, name)
        if module == "srslte_emane_tpu_torch" or module.startswith("srslte_emane_tpu_torch."):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"wire: refusing to unpickle {module}.{name}")


def safe_loads(data: bytes):
    return _RestrictedUnpickler(io.BytesIO(data)).load()


def dumps(obj) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)

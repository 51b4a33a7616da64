"""Algorithm registry (paper Fig. 4, Algorithm Layer).

Codecs self-register at import; ``repro_torch.algos`` imports them all.  A codec
provides host-side ``encode``, a numpy ``decode_np`` oracle and a ``stages``
lowering onto the patterns of ``repro_torch.core.patterns``.
"""
from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Codec(Protocol):
    name: str
    pattern: str  # "fp" | "gp" | "np" | "aux" -- dominant pattern family (Table 1)
    # Data-dependent meta keys LIFTED out of program identity into runtime operands,
    # mapped to the operand dtype (e.g. {"bit_width": np.int32}).  Lifted keys are
    # hashed by dtype/shape only in the structural signature; stages read them from
    # (1,)-operand buffers, never bake the values.
    lifted_meta: dict[str, Any] = {}

    def encode(self, arr: np.ndarray, **params) -> tuple[dict[str, np.ndarray], dict]:
        """-> (buffers, meta).  Buffers may be re-compressed by child plans."""
        ...

    def decode_np(self, bufs: dict[str, np.ndarray], meta: dict, n: int,
                  dtype: Any) -> np.ndarray:
        """Pure-numpy decode given already-decoded child buffers."""
        ...

    def stages(self, enc, buf_names: dict[str, str], out_name: str,
               meta_names: dict[str, str] | None = None) -> list:
        """Lower decode onto pattern stages (repro_torch.core.patterns).

        ``meta_names`` maps each lifted meta key to its operand env name; the
        returned stages list those names among their inputs (BufSpec "full")."""
        ...


_REGISTRY: dict[str, Codec] = {}


def register(codec: Codec) -> Codec:
    _REGISTRY[codec.name] = codec
    return codec


def get(name: str) -> Codec:
    if name not in _REGISTRY:
        import repro_torch.algos  # noqa: F401  -- trigger codec registration
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown codec '{name}'; known: {sorted(_REGISTRY)}") from None


def names() -> list[str]:
    import repro_torch.algos  # noqa: F401

    return sorted(_REGISTRY)

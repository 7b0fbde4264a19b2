"""Build the port's compiled traces from the reference's.

Reads a ``repro.runtime_stream`` ``CompiledTrace``'s attributes (NumPy
arrays, tuples, floats) without importing ``repro``, as
``repro_torch.core.convert`` does for graphs and clusters, so tests can run
one compiled scenario through both packages. Arrays are copied.
"""

from __future__ import annotations

import numpy as np

from repro_torch.runtime_stream.traces import CompiledTrace, KeyedEdgeTrace, KeyRealization

__all__ = ["compiled_trace"]


def _key_realization(ref) -> KeyRealization:
    return KeyRealization(
        edge=tuple(ref.edge),
        weights=np.array(ref.weights, copy=True),
        hashes=np.array(ref.hashes, copy=True),
    )


def compiled_trace(ref) -> CompiledTrace:
    """Port ``CompiledTrace``: rates, capacity grid, events, seed and every
    keyed edge's realization segments."""
    return CompiledTrace(
        name=ref.name,
        window_s=float(ref.window_s),
        rates=np.array(ref.rates, copy=True),
        capacity=np.array(ref.capacity, copy=True),
        events=tuple((int(w), str(what)) for w, what in ref.events),
        seed=ref.seed,
        keyed=tuple(
            KeyedEdgeTrace(
                edge=tuple(kt.edge),
                segments=tuple((int(s), _key_realization(r)) for s, r in kt.segments),
            )
            for kt in ref.keyed
        ),
    )

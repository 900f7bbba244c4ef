"""Device-mesh helpers.

The codec's parallelism axes (SURVEY.md §2.7): streams are the data axis
(embarrassingly parallel, sharded over the devices), and the filterbank matmul's
frequency contraction can additionally be tensor-parallel for very wide
transcode pipelines.  No reference counterpart exists (the reference is a
single-threaded Windows codec); this is new design.
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(data: int | None = None, model: int = 1,
              devices=None) -> Mesh:
    """2D ('data', 'model') mesh.  Defaults to all devices on 'data'."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if data is None:
        data = n // model
    assert data * model == n, f"mesh {data}x{model} != {n} devices"
    arr = np.array(devices).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))


def stream_sharding(mesh: Mesh) -> NamedSharding:
    """Leading stream-batch axis sharded over 'data'."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())

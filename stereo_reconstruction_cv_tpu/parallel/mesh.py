"""Device-mesh helpers.

The framework uses a 2D logical mesh:

  'data'  — batch parallelism over stereo pairs / calibration views
            (DCN-friendly: no intra-step communication)
  'space' — spatial parallelism: image rows sharded across chips for the
            dense-disparity cost volume (halo exchange at shard
            boundaries) — the project's analog of sequence/context
            parallelism (SURVEY §2.4, §5 long-context row)
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_data: int | None = None,
    n_space: int = 1,
    devices: Sequence[jax.Device] | None = None,
) -> Mesh:
    """Build a ('data', 'space') mesh. Defaults: all devices on 'data'."""
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_space
    assert n_data * n_space <= len(devices), (
        f"need {n_data}x{n_space} devices, have {len(devices)}"
    )
    grid = np.array(devices[: n_data * n_space]).reshape(n_data, n_space)
    return Mesh(grid, ("data", "space"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis batch sharding over 'data'."""
    return NamedSharding(mesh, P("data"))


def batch_row_sharding(mesh: Mesh) -> NamedSharding:
    """(batch, rows, cols) arrays: batch over 'data', rows over 'space'."""
    return NamedSharding(mesh, P("data", "space"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())

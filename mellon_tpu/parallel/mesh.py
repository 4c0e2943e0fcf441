"""Device-mesh construction and multi-host initialization.

NEW capability relative to the reference, which is strictly single-process
single-device (SURVEY.md §2.4: no pmap/pjit/shard_map/jax.distributed
anywhere).  The canonical mesh for this framework has two axes:

* ``chains``  — MCMC chains / SMC particle blocks (data-parallel sampling);
* ``cells``   — rows of the n×m transformation matrix L and the per-cell
  likelihood terms (data parallelism over cells; Mellon's analogue of
  sequence parallelism, SURVEY.md §5.7).

Collectives run over the devices' interconnect (NVLink between the GPUs
of one host); on CPU test meshes the same program runs over
``jax_num_cpu_devices`` virtual devices.
"""

import logging

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

logger = logging.getLogger("mellon_tpu")

CHAIN_AXIS = "chains"
CELL_AXIS = "cells"


def distributed_initialize(**kwargs):
    """Initialize multi-host JAX (one process per host on a pod slice).

    Thin wrapper over ``jax.distributed.initialize`` that is safe to call
    when already initialized or when running single-process.
    """
    try:
        jax.distributed.initialize(**kwargs)
        logger.info(
            "jax.distributed initialized: process %d / %d",
            jax.process_index(),
            jax.process_count(),
        )
    except (RuntimeError, ValueError) as e:
        logger.info("jax.distributed not (re-)initialized: %s", e)


def create_mesh(n_chains=None, n_cells=None, devices=None):
    """Create a (chains, cells) mesh over the available devices.

    With ``n_chains=None`` the full device count goes to the chain axis; with
    both given their product must equal the device count.
    """
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if n_chains is None and n_cells is None:
        n_chains, n_cells = n_dev, 1
    elif n_chains is None:
        n_chains = n_dev // n_cells
    elif n_cells is None:
        n_cells = n_dev // n_chains
    if n_chains * n_cells != n_dev:
        raise ValueError(
            f"Mesh {n_chains}x{n_cells} does not match {n_dev} devices."
        )
    dev_array = np.asarray(devices).reshape(n_chains, n_cells)
    return Mesh(dev_array, (CHAIN_AXIS, CELL_AXIS))


def cell_sharding(mesh, ndim=1):
    """Sharding that splits the leading (cells) axis of an array."""
    spec = P(CELL_AXIS, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def chain_sharding(mesh):
    """Sharding that splits the leading (chains) axis of an array."""
    return NamedSharding(mesh, P(CHAIN_AXIS))


def replicated(mesh):
    return NamedSharding(mesh, P())

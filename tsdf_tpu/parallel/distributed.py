"""Multi-host bootstrap + fail-fast semantics.

The reference has no distributed layer (SURVEY.md §5): its only
"transport" is cudaMemcpy and files on disk. Here multi-host runs use
``jax.distributed`` for process bootstrap, the global mesh spans all
hosts (NVLink within a host, the network across), and recovery is
checkpoint-restart (utils/checkpoint.py) — the standard JAX multi-host
fail-fast model, replacing the reference's ``exit(-1)`` on CUDA error
(ref: src/Utilities/cuda_utilities.cu:5-11).
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bootstrap multi-host JAX; no-op in single-process runs.

    Arguments default from the standard env (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    """
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(n_rays: int = 1):
    """A ("b", "r") mesh over every device of every host."""
    from .mesh import make_mesh

    return make_mesh(n_rays=n_rays)


def is_coordinator() -> bool:
    return jax.process_index() == 0

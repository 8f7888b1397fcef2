"""Multi-host launch glue (SURVEY.md §2.2 "collectives backend" row).

The reference is a single-JVM library; its only concurrency story is that
constructed matchers are immutable and may be shared across reader threads
(no analog to any of this exists there).  Here a corpus scan scales across
hosts with ``jax.distributed`` and a global device mesh; this module is the
bring-up glue:

* :func:`initialize` — idempotent ``jax.distributed`` coordinator setup
  (no-op for single-process runs, which covers the attached-chip and
  CPU-simulation environments).
* :func:`global_data_mesh` — one-axis mesh over every device in the job,
  across hosts; the sharded scan kernels (``parallel/sharding.py``) run on
  it unchanged — halo ``ppermute`` and ``psum`` span every device of the
  job.
* :func:`prepare_process_local` — assemble the globally-sharded class array
  from per-host local text shards without ever materializing the full
  corpus on one host (``jax.make_array_from_process_local_data``).  Global
  match offsets are recovered from the returned per-process unit offset, as
  matches are shard-local once the halo fixes entry states (the stream-mode
  invariant, ``AhoCorasickMap.java:208-275``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> bool:
    """Bring up ``jax.distributed`` if this looks like a multi-process job.

    Returns True when distributed mode is (or already was) initialized
    IN THIS PROCESS.  With no explicit arguments and no coordinator
    environment variable (``JAX_COORDINATOR_ADDRESS``), this is a no-op
    returning False — without forcing backend bring-up.  Environments
    that self-initialize multi-process state outside ``jax.distributed``
    should pass explicit arguments.  Calling twice is safe.
    """
    import jax

    explicit = (
        coordinator_address is not None
        or num_processes not in (None, 1)
        or process_id is not None
    )
    env = os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
        "COORDINATOR_ADDRESS"
    )
    if not explicit and not env:
        # Answer WITHOUT forcing backend initialization: jax.process_count()
        # would bring up the device client just to report a single-process
        # no-op.
        state = getattr(jax.distributed, "global_state", None)
        return bool(state is not None and state.client is not None)
    try:
        jax.distributed.initialize(
            # A bespoke COORDINATOR_ADDRESS env var is not one of JAX's
            # cluster auto-detection inputs; pass it through explicitly.
            coordinator_address=coordinator_address or env,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise
    return True


def global_data_mesh(axis: str = "data"):
    """One-axis mesh over all devices in the job (all hosts)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def prepare_process_local(
    cls_local: np.ndarray,
    mesh,
    local_units: int,
    chunk: int = 512,
) -> Tuple["object", int]:
    """Globally-sharded class array from this host's local shard.

    Every process passes its own contiguous slice of the corpus (in class
    space, ``matcher._classes``) and the common per-process capacity
    ``local_units`` (must be identical across processes and a multiple of
    ``chunk * local_device_count``; shorter final shards are padded with
    the non-advancing class 0).  Returns ``(global_array, unit_offset)``
    where ``unit_offset`` is the global position of this shard's first unit
    — add it to shard-local match positions.

    Single-process jobs degenerate to a plain sharded ``device_put``, so the
    same launch code runs everywhere (CPU simulation included).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    # The unit_offset formula below (process_index * local_units) requires
    # the mesh to order devices contiguously by ascending process index —
    # the layout jax.devices()/global_data_mesh produce.  Verify rather
    # than assume: a permuted mesh would scatter this host's shard to the
    # wrong global positions and silently corrupt every match offset.
    proc_of = [d.process_index for d in mesh.devices.flat]
    if proc_of != sorted(proc_of):
        raise ValueError(
            "mesh devices are not grouped by ascending process index; "
            "unit_offset would not match the shard placement — build the "
            "mesh with global_data_mesh (jax.devices() order)"
        )
    n_local_dev = len(
        [d for d in mesh.devices.flat if d.process_index == jax.process_index()]
    )
    if local_units % (chunk * max(n_local_dev, 1)) != 0:
        raise ValueError(
            f"local_units ({local_units}) must be a multiple of chunk x "
            f"local device count ({chunk} x {n_local_dev})"
        )
    if len(cls_local) > local_units:
        raise ValueError("cls_local longer than local_units")
    padded = np.zeros(local_units, dtype=np.int32)
    padded[: len(cls_local)] = cls_local
    sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
    if jax.process_count() == 1:
        arr = jax.device_put(jnp.asarray(padded), sharding)
    else:
        arr = jax.make_array_from_process_local_data(sharding, padded)
    return arr, jax.process_index() * local_units

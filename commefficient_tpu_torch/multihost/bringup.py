"""Multi-host bring-up — from the environment to a checked worker group
(the port's counterpart of the reference's ``multihost/bringup.py``).

The one entry every multi-node process runs before touching a device:

    joined = initialize_multihost(cfg)   # torch.distributed, if asked
    group = make_global_mesh(cfg)        # the worker group, host axis on

Both are the reference's names over the port's one env:// bring-up,
``parallel.mesh.join_from_env``: under ``--distributed`` it requires the
coordinator environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``), connects (NCCL for ``--device cuda``, gloo for
the CPU) under a bounded retry-with-backoff, and refuses a joined cluster
whose node count (``WORLD_SIZE / LOCAL_WORLD_SIZE``) is not
``--num_hosts`` or whose ``WORLD_SIZE`` is not ``--num_devices``. Without
``--distributed`` a host axis runs over the ranks of one node
(``torchrun --nproc_per_node N``, or a group the caller initialized), the
reference's mesh-faked twin. The train entries reach the same bring-up
through ``parallel.mesh.distributed_from_env``.
"""

from __future__ import annotations

from commefficient_tpu_torch.parallel.mesh import (
    join_from_env,
    make_worker_group,
)


def initialize_multihost(cfg) -> bool:
    """Join the cluster if the config asks for it; return whether a
    multi-node group is up.

    * ``cfg.distributed`` False: touches nothing, returns False — a host
      axis over one node's ranks and every single-host run land here.
    * ``cfg.distributed`` True: ``join_from_env(cfg)``, failing LOUDLY on a
      missing coordinator environment, a spent connect budget, or a
      cluster that disagrees with ``num_hosts`` / ``num_devices``."""
    if not cfg.distributed:
        return False
    join_from_env(cfg)
    return True


def make_global_mesh(cfg):
    """The run's worker group from the config, with its host axis
    (``hosts``, ``host_id``, ``workers_per_host``) when ``cfg.num_hosts >
    1``. Call AFTER :func:`initialize_multihost`, so the group spans the
    cluster."""
    return make_worker_group(cfg)

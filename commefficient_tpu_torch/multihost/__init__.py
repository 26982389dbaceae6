"""multihost/ — running over several hosts (the port's counterpart of the
reference's ``commefficient_tpu/multihost/``).

FetchSGD's server is a sum, and a sum over a cluster is one collective, so
the multi-host story is a TOPOLOGY story, not an algorithm story. This
package owns the three planes of a distributed run:

* **topology** (``topology.py``): the worker group grows a host axis
  (``parallel/mesh.py``: ``hosts``, ``host_id``, ``workers_per_host``,
  host-major ranks), and :class:`HostTopology` derives each host's ranks,
  worker-slot range and client partition from the config.
* **data plane** (``dataplane.py``): library pieces with which a caller
  can make each process realize only its partition: its slots' sampler
  draws on its own rng stream, its rows of the (globally deterministic)
  fedsim ``RoundEnv``, and a clientstore bank holding only its clients;
  ``assemble_rows`` lays the slices out as the session's ``[W, ...]``
  batch without realizing another host's rows. The train entries do not
  use them (nor do the reference's): ``cv_train`` / ``gpt2_train`` with
  ``--num_hosts N`` draw the whole ``[W]`` cohort through ``FedSampler``
  on every rank and realize every host's rows; the host axis changes the
  group's ``hosts`` / ``host_id``, the ``multihost/*`` scalars and the
  report's ``multihost`` block. A caller that wants the partitioned
  round drives ``FederatedSession.train_round`` with the data plane's
  ids and rows (tests/test_torch_multihost.py's two-node leg does).
* **aggregation plane**: no code here by design. Every collective of the
  worker group stays ONE call over the whole group (the reference's one
  reduction over the ``(hosts, workers)`` tuple axis); as in the
  reference, no round path runs the sparse butterfly's two-level
  schedule (``ops/collectives/sparse_allreduce.py``, ``axis_sizes=``).

Two execution modes, one semantics: **several nodes** (``--distributed``;
``bringup.initialize_multihost``, the train entries' ``parallel.mesh.
distributed_from_env``, joins them through torch.distributed's env://
rendezvous, one host a node) and **one node** (``--num_hosts N``
over the ranks of one ``torchrun --nproc_per_node`` group, the
reference's mesh-faked twin). Both are bit-equal to the run without a host
axis (``tests/test_torch_multihost.py``).
"""

from commefficient_tpu_torch.multihost.bringup import (
    initialize_multihost,
    make_global_mesh,
)
from commefficient_tpu_torch.multihost.dataplane import (
    MULTIHOST_STREAM,
    HostClientBank,
    HostDataPlane,
    assemble_cohort,
    assemble_rows,
    build_host_bank,
    global_client_ids,
    round_env_slice,
)
from commefficient_tpu_torch.multihost.topology import (
    HostTopology,
    build_topology,
    client_partition,
    slot_partition,
    validate_mesh_topology,
)

__all__ = [
    "MULTIHOST_STREAM",
    "HostClientBank",
    "HostDataPlane",
    "HostTopology",
    "assemble_cohort",
    "assemble_rows",
    "build_host_bank",
    "build_topology",
    "client_partition",
    "global_client_ids",
    "initialize_multihost",
    "make_global_mesh",
    "round_env_slice",
    "slot_partition",
    "validate_mesh_topology",
]

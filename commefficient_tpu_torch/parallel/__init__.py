"""The round engine, the session and the process grid of the port: the
reference's ``parallel`` names. ``make_mesh`` is ``mesh.build_grid``: one
process a mesh position, the ``WORKERS``/``MODEL``/``SEQ`` groups a
``Grid``'s attributes; ``build_tp3d_train_step`` takes the grid and the
``GPT2Config`` where the reference takes the mesh and the model."""

from commefficient_tpu_torch.parallel.api import (
    FederatedSession,
    FedModel,
    FedOptimizer,
    make_fed_pair,
)
from commefficient_tpu_torch.parallel.mesh import (
    MODEL,
    SEQ,
    WORKERS,
    build_grid as make_mesh,
)
from commefficient_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_attention_sharded,
)
from commefficient_tpu_torch.parallel.round import (
    FedState,
    build_eval_fn,
    build_round_fn,
    init_state,
    mask_classification,
    mask_gpt2,
)
from commefficient_tpu_torch.parallel.sequence import sp_gpt2_apply
from commefficient_tpu_torch.parallel.tensor import (
    build_tp3d_train_step,
    tp_gpt2_apply,
    tp_shard_params,
    tp_untransform_params,
)

__all__ = ["make_mesh", "WORKERS", "MODEL", "SEQ", "FedState", "init_state",
           "build_round_fn", "build_eval_fn", "mask_classification",
           "mask_gpt2", "FederatedSession", "FedModel", "FedOptimizer",
           "make_fed_pair", "ring_attention", "ring_attention_sharded",
           "sp_gpt2_apply", "build_tp3d_train_step", "tp_gpt2_apply",
           "tp_shard_params", "tp_untransform_params"]

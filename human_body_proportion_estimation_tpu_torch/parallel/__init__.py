"""Multi-device serving and training: the ("data", "model") mesh and its
placement rules (`mesh`), and lockstep serving over `torch.distributed`
processes (`multihost`)."""

from human_body_proportion_estimation_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    make_mesh,
    param_shardings,
    replicated,
)

"""Multi-device execution of the port on ``torch.distributed``, port of the
JAX package's ``parallel`` package: meshes (``mesh``), the collectives of
the SPMD code (``collectives``), halo-sharded whole-gland inference and
training (``halo``) and tensor-parallel parameter state (``sharding``).
Data-parallel inference runs one replica a device in one process
(``serve.InferenceSession(mesh=)``); training and spatial sharding run one
process a mesh position (``train.trainer.make_train_step(mesh=)``)."""

from .mesh import (  # noqa: F401
    Mesh,
    assert_batch_divisible,
    data_sharding,
    host_local_batch_to_global,
    initialize_distributed,
    make_hybrid_mesh,
    make_mesh,
    replicated,
    setup_device,
)

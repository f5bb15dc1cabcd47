# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Process meshes over ``torch.distributed``: mesh construction, sharding,
explicit collectives (port of ``parallel/``).

JAX's ``batch_sharding`` and ``replicated_sharding`` place arrays on a
mesh; a rank here holds its own tensors, so their counterparts are
:func:`~rein48_tpu_torch.parallel.mesh.shard_batch` (the rank's rows) and
the tensor as it is.
"""

from rein48_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshConfig,
    make_mesh,
    shard_batch,
    shard_env_state,
)
from rein48_tpu_torch.parallel.spmd import psum_mean_grads  # noqa: F401

"""Serving and training on a ("data", "model") mesh of torch.distributed
ranks (the port of recom_tpu/parallel/)."""

from recom_tpu_torch.parallel.all_to_all_lookup import (  # noqa: F401
    all_to_all_group_pooled,
)
from recom_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from recom_tpu_torch.parallel.sharded_lookup import (  # noqa: F401
    sharded_group_pooled,
)

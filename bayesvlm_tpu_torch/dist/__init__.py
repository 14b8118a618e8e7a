"""Distribution over one process per card (torch.distributed), the
counterpart of `bayesvlm_tpu.dist`. `local_rows` stands for JAX's
`data_sharding` (a rank's block of rows); JAX's `replicated` needs none:
every rank holds the full inputs and the collectives' results. JAX's
`default_mesh()` needs none of its own: with one device a rank it is
`make_mesh()`."""

from bayesvlm_tpu_torch.dist.mesh import local_rows, make_mesh
from bayesvlm_tpu_torch.dist.hessian_allreduce import (
    sharded_activation_gram,
    sharded_hessian_infonce,
    sharded_hessian_siglip,
)

__all__ = [
    "make_mesh",
    "local_rows",
    "sharded_hessian_infonce",
    "sharded_hessian_siglip",
    "sharded_activation_gram",
]

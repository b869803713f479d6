"""Data-parallel training and sharded serving across processes, one a
card (port of ``fcl_taco2_tpu/parallel``)."""

from fcl_taco2_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_hybrid_mesh, make_mesh, mesh_for)

"""Entry points and the device meshes.

:mod:`~repro_torch.launch.mesh` holds the mesh that shards the batched
controllers' VM axis and training's model meshes (host, production and
abstract); :mod:`~repro_torch.launch.serve`,
:mod:`~repro_torch.launch.train` and :mod:`~repro_torch.launch.steps`
serve and train models, :mod:`~repro_torch.launch.sharding` holds the
sharding rules and :mod:`~repro_torch.launch.dryrun`,
:mod:`~repro_torch.launch.roofline`, :mod:`~repro_torch.launch.sweep`
and :mod:`~repro_torch.launch.trace_analysis` the dry-run tools; each is
imported on its own.
"""
from repro_torch.launch.mesh import (AbstractMesh, ModelMesh, VMMesh,
                                     abstract_production_mesh, axis_size,
                                     device_row_blocks, dp_axes,
                                     make_host_mesh, make_production_mesh,
                                     make_vm_mesh, require_vm_divisible)

__all__ = ["AbstractMesh", "ModelMesh", "VMMesh",
           "abstract_production_mesh", "axis_size", "device_row_blocks",
           "dp_axes", "make_host_mesh", "make_production_mesh",
           "make_vm_mesh", "require_vm_divisible"]

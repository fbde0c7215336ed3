"""Entry points and the device meshes.

:mod:`~repro_torch.launch.mesh` holds the mesh that shards the batched
controllers' VM axis and training's host mesh;
:mod:`~repro_torch.launch.serve`, :mod:`~repro_torch.launch.train` and
:mod:`~repro_torch.launch.steps` serve and train models and are imported
on their own.
"""
from repro_torch.launch.mesh import (ModelMesh, VMMesh, axis_size,
                                     device_row_blocks, dp_axes,
                                     make_host_mesh, make_vm_mesh,
                                     require_vm_divisible)

__all__ = ["ModelMesh", "VMMesh", "axis_size", "device_row_blocks",
           "dp_axes", "make_host_mesh", "make_vm_mesh",
           "require_vm_divisible"]

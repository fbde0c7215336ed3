"""Entry points and the VM-axis device mesh.

:mod:`~repro_torch.launch.mesh` holds the mesh that shards the batched
controllers' VM axis; :mod:`~repro_torch.launch.serve` and
:mod:`~repro_torch.launch.steps` serve models and are imported on their
own.
"""
from repro_torch.launch.mesh import (VMMesh, device_row_blocks, make_vm_mesh,
                                     require_vm_divisible)

__all__ = ["VMMesh", "device_row_blocks", "make_vm_mesh",
           "require_vm_divisible"]

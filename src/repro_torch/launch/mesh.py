"""The VM-axis device mesh of the batched controllers.

The counterpart of the VM half of :mod:`repro.launch.mesh`. A
:class:`VMMesh` is an ordered tuple of ``torch.device``\\ s, one a shard:
batched ``[V, ...]`` controller state is split into ``V / d``-row blocks,
block ``i`` held in tensors of its own on ``devices[i]``, and every
sharded dispatch runs the single-device batched function once a block
(:mod:`repro_torch.core.simulator`). A device may repeat: several shards
on one card, or on the CPU, where the JAX package forces placeholder
devices (``--xla_force_host_platform_device_count``) for the same
purpose. The JAX package's ``vm_spec`` has no counterpart here: its
role, placing each row block on its device, is :func:`device_row_blocks`.

The model mesh of training is :class:`ModelMesh` (``make_host_mesh``,
``dp_axes``, ``axis_size``): the reference's ``('data', 'model')`` mesh
as a grid of devices. The reference's ``make_production_mesh`` is
dry-run machinery and waits with its ``dryrun.py`` (ROADMAP Queue 1
item 9).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class VMMesh:
    """A 1-d mesh over the VM axis: ``devices[i]`` holds shard ``i``."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a VM mesh needs at least one device")
        if len({d.type for d in devs}) != 1 or devs[0].type not in (
                "cuda", "cpu"):
            raise ValueError(f"a VM mesh's devices must be all CUDA or all "
                             f"CPU, got {[str(d) for d in devs]}")
        # a CUDA device without an index is the card it would select now
        cur = torch.cuda.current_device() if torch.cuda.is_available() else 0
        devs = tuple(torch.device("cuda", cur)
                     if d.type == "cuda" and d.index is None else d
                     for d in devs)
        object.__setattr__(self, "devices", devs)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("vm",)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type


def make_vm_mesh(num_shards: int | None = None) -> VMMesh:
    """A mesh over the first ``num_shards`` CUDA devices (every device
    with ``None``). Raises ``ValueError`` when there are fewer cards than
    shards, none included; it never falls back to the CPU. Build
    ``VMMesh((torch.device("cuda", 0),) * d)`` for ``d`` shards on one
    card, or ``VMMesh((torch.device("cpu"),) * d)`` for the plain
    path."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if num_shards is None else num_shards
    if n < 1 or n > have:
        raise ValueError(
            f"VM mesh wants {n} shards but only {have} CUDA devices exist "
            "— give VMMesh repeated devices to place several shards on one "
            "card (or on the CPU)")
    return VMMesh(tuple(torch.device("cuda", i) for i in range(n)))


def require_vm_divisible(num_vms: int, mesh: VMMesh) -> None:
    """Reject VM counts the mesh cannot split evenly (callers pad
    first)."""
    if num_vms % mesh.size != 0:
        raise ValueError(
            f"sharded dispatch needs the VM count ({num_vms}) divisible by "
            f"the mesh size ({mesh.size}); pad with dead VMs (addr=-1 / "
            f"empty sub-traces) first")


def device_row_blocks(num_rows: int, mesh: VMMesh
                      ) -> list[tuple[torch.device, slice]]:
    """``[(device, row_slice), ...]`` splitting ``num_rows`` evenly over
    the mesh's devices, in mesh order."""
    require_vm_divisible(num_rows, mesh)
    per = num_rows // mesh.size
    return [(dev, slice(i * per, (i + 1) * per))
            for i, dev in enumerate(mesh.devices)]


def on_device(dev: torch.device):
    """A context in which kernels launch on ``dev``'s current stream (a
    CUDA device's context; nothing for the CPU)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


@dataclasses.dataclass(frozen=True)
class ModelMesh:
    """A device grid with named axes: ``devices[i][j]`` sits at index i
    of the first axis and j of the second (``('data', 'model')`` for the
    host mesh)."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])


def make_host_mesh(model: int = 1, device="cuda") -> ModelMesh:
    """Degenerate ``('data', 'model')`` mesh over the devices of
    ``device``'s type: every card for CUDA, the one CPU device for the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device("cpu")]
    n = len(devs)
    if n == 0 or n % model:
        raise ValueError(
            f"host mesh needs the device count ({n}) divisible by the "
            f"requested model-axis size ({model}) for shape "
            f"({n // model}, {model})")
    return ModelMesh(tuple(tuple(devs[i * model:(i + 1) * model])
                           for i in range(n // model)), ("data", "model"))


def dp_axes(mesh) -> tuple[str, ...]:
    """The batch-carrying axes of a mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1

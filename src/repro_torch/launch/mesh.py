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

The model meshes of training are :class:`ModelMesh`, a grid of devices
with any number of named axes (``('data', 'model')`` for the host mesh,
``('pod', 'data', 'model')`` for the multi-pod production mesh), and
:class:`AbstractMesh`, the same axis names and sizes without devices:
the production meshes of :func:`make_production_mesh` need 256 or 512
devices, so the dry-run (:mod:`repro_torch.launch.dryrun`) plans over
:func:`abstract_production_mesh`. The sharding rules
(:mod:`repro_torch.launch.sharding`) read only ``axis_names`` and
``shape``, so they take either.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

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


def _grid_shape(devices, depth: int) -> tuple[int, ...]:
    """The sizes of a ``depth``-deep grid of nested tuples; raises on a
    ragged one."""
    if depth == 0:
        return ()
    if not isinstance(devices, tuple) or not devices:
        raise ValueError("a mesh axis needs a non-empty tuple of entries")
    inner = {_grid_shape(d, depth - 1) for d in devices}
    if len(inner) != 1:
        raise ValueError("a mesh's device grid must be rectangular")
    return (len(devices),) + inner.pop()


@dataclasses.dataclass(frozen=True)
class ModelMesh:
    """A device grid with named axes: ``devices`` nests one tuple level
    an axis, ``devices[i][j]`` at index i of the first axis and j of the
    second (``('data', 'model')`` for the host mesh; three levels for
    ``('pod', 'data', 'model')``). A device may repeat."""

    devices: tuple
    axis_names: tuple[str, ...]

    def __post_init__(self):
        _grid_shape(self.devices, len(self.axis_names))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names,
                        _grid_shape(self.devices, len(self.axis_names))))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes without devices (the reference
    dry-run's 256 and 512 placeholder devices have no counterpart on one
    card): what the sharding rules and the dry-run's byte counts read."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names) or any(
                n < 1 for n in self.axis_sizes):
            raise ValueError(f"axis sizes {self.axis_sizes} for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def production_shape(multi_pod: bool = False):
    """``(shape, axis names)`` of the production mesh: 16 x 16 =
    256 devices over ``('data', 'model')``, or 2 x 16 x 16 = 512 over
    ``('pod', 'data', 'model')`` (the ``'pod'`` axis carries batch
    only)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def abstract_production_mesh(multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's axes without devices."""
    return AbstractMesh(*production_shape(multi_pod))


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> ModelMesh:
    """The production mesh over the first 256 (or 512) devices of
    ``device``'s type. Raises ``ValueError`` when fewer exist, as the
    reference does; plan over :func:`abstract_production_mesh` then."""
    shape, axes = production_shape(multi_pod)
    n = math.prod(shape)
    dev = torch.device(device)
    have = (torch.cuda.device_count() if dev.type == "cuda"
            and torch.cuda.is_available() else 1 if dev.type == "cpu"
            else 0)
    if have < n:
        raise ValueError(
            f"need {n} devices for mesh shape {shape} with axes {axes}, "
            f"have {have} — plan over abstract_production_mesh() (the "
            "dry-run, repro_torch.launch.dryrun) instead")
    flat = [torch.device(dev.type, i) for i in range(n)]
    for size in reversed(shape[1:]):
        flat = [tuple(flat[i:i + size]) for i in range(0, len(flat), size)]
    return ModelMesh(tuple(flat), axes)


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

"""Device meshes (counterpart of ``repro.launch.mesh``): the model meshes
of the serve and train drivers, and the plane meshes of the server's
parameter plane and the client fleet.

A :class:`ModelMesh` has the axes ``("data", "model")`` (``pod``: 16 x 16)
or ``("pod", "data", "model")`` (``multipod``: 2 x 16 x 16); ``smoke`` is
a 1 x 1 mesh of the same axes. The batch spreads over ``("pod", "data")``
and heads, FFN width and vocabulary over ``model``
(:mod:`repro_torch.launch.shardings` holds each leaf's placement,
:mod:`repro_torch.launch.sharded` the per-shard compute).

A :class:`PlaneMesh` is a grid of devices with the axes ``("plane",)`` or
``("plane", "model")``: rows (cluster centers, broadcast anchors, last
uploads, client models) spread over ``plane``, and the flat parameter dim
may also spread over ``model``. One process drives the whole mesh, as one
JAX controller drives the reference's ``jax.make_mesh``: it holds one
tensor a shard, on that shard's device, launches the single-device kernel
on each shard's operand and joins the results on the mesh's first device
(:mod:`repro_torch.kernels.plane_sharded`). No ``torch.distributed``.

A device list may name one device several times, as JAX's forced host
device count does: eight ``cpu`` shards on one CPU, or an 8-shard mesh on
one card, run every shard's launches, padding and joins for real.

A model mesh is driven the same way: one process holds each parameter
block once a device and runs every shard's launches and joins.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

# Roofline constants of one card, from NVIDIA's data sheet for the NVIDIA H100
# 80GB HBM3, 700 W (SXM5) part; dense rates, without sparsity. The dry-run
# (launch/dryrun.py) and chip_smoke.py's bounds read these.
H100_HBM_BYTES_PER_S = 3.35e12     # NVIDIA H100 80GB HBM3, 700 W: HBM3 bandwidth 3.35 TB/s
H100_BF16_FLOPS_PER_S = 989e12     # NVIDIA H100 80GB HBM3, 700 W: BF16 tensor cores, 989 TFLOP/s dense
H100_TF32_FLOPS_PER_S = 495e12     # NVIDIA H100 80GB HBM3, 700 W: TF32 tensor cores, 495 TFLOP/s dense
H100_FP32_FLOPS_PER_S = 67e12      # NVIDIA H100 80GB HBM3, 700 W: FP32 outside the tensor cores, 67 TFLOP/s
H100_NVLINK_BYTES_PER_S = 450e9    # NVIDIA H100 80GB HBM3, 700 W: NVLink 900 GB/s, 450 GB/s each direction


def peak_flops(dtype: torch.dtype) -> float:
    """The card's peak for products in ``dtype``: the bf16 tensor cores for
    bf16 and fp16, fp32 outside the tensor cores for fp32 (the port keeps
    TF32 off for PyTorch's own products, ``common/device.py``)."""
    if dtype in (torch.bfloat16, torch.float16):
        return H100_BF16_FLOPS_PER_S
    if dtype == torch.float32:
        return H100_FP32_FLOPS_PER_S
    raise ValueError(f"no H100 peak for {dtype}")


@dataclasses.dataclass(frozen=True)
class PlaneMesh:
    """An R x M grid of devices; ``devices[r][m]`` holds row shard ``r``'s
    ``m``-th dim chunk (M = 1 without a ``model`` axis)."""

    axis_names: tuple[str, ...]
    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> extent, as ``jax.sharding.Mesh.shape``."""
        extents = (len(self.devices), len(self.devices[0]))
        return dict(zip(self.axis_names, extents))

    @property
    def row_shards(self) -> int:
        """The ``plane`` axis's extent: the shards that rows spread over."""
        return len(self.devices)

    @property
    def first_device(self) -> torch.device:
        """Where the mesh's joins land and its small operands live."""
        return self.devices[0][0]

    def __repr__(self) -> str:
        return f"PlaneMesh({self.shape}, {sorted({str(d) for row in self.devices for d in row})})"


def _cards() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_plane_mesh(row_shards: int | None = None, *, dim_shards: int = 1,
                    devices: Sequence[torch.device | str] | None = None) -> PlaneMesh:
    """A mesh of ``row_shards`` x ``dim_shards`` devices, taken in order from
    ``devices`` (default: every visible card): axes ``("plane",)``, or
    ``("plane", "model")`` when ``dim_shards > 1``. ``row_shards=None``
    takes every device."""
    devs = [torch.device(d) for d in (_cards() if devices is None else devices)]
    n = len(devs)
    if dim_shards < 1 or n % dim_shards != 0:
        raise ValueError(f"dim_shards {dim_shards} must divide device count {n}")
    if row_shards is None:
        row_shards = n // dim_shards
    if row_shards < 1 or row_shards * dim_shards > n:
        raise ValueError(f"a {row_shards} x {dim_shards} mesh needs {row_shards * dim_shards} devices, "
                         f"{n} {'visible cards' if devices is None else 'given'}")
    grid = tuple(tuple(devs[r * dim_shards + m] for m in range(dim_shards)) for r in range(row_shards))
    axes = ("plane",) if dim_shards == 1 else ("plane", "model")
    return PlaneMesh(axes, grid)


def parse_spec(spec: str) -> None | str | tuple[int, int]:
    """The reference's mesh grammar: ``""``/``"0"``/``"off"``/``"none"`` ->
    None (off); ``"auto"``; ``"R"`` -> (R, 1), so ``"1"`` is a one-shard
    mesh; ``"RxM"`` -> (R, M)."""
    spec = spec.strip().lower()
    if spec in ("", "0", "off", "none"):
        return None
    if spec == "auto":
        return "auto"
    if "x" in spec:
        rows, dims = (int(p) for p in spec.split("x", 1))
        return rows, dims
    return int(spec), 1


def mesh_from_spec(spec: str, devices: Sequence[torch.device | str] | None = None) -> PlaneMesh | None:
    """A mesh from a spec string over ``devices`` (default: the visible
    cards); ``"auto"`` takes them all, and gives None when there is one."""
    parsed = parse_spec(spec)
    if parsed is None:
        return None
    if parsed == "auto":
        n = len(_cards() if devices is None else devices)
        return None if n <= 1 else make_plane_mesh(n, devices=devices)
    rows, dims = parsed
    return make_plane_mesh(rows, dim_shards=dims, devices=devices)


def resolve_mesh(mesh: PlaneMesh | str | None, device: torch.device | str) -> PlaneMesh | None:
    """An entry point's ``plane_mesh=``/``fleet_mesh=`` argument: a
    :class:`PlaneMesh` as it is, None off, a spec string over the cards, or
    on the CPU over ``R x M`` shards of the one ``cpu`` device (``"auto"``
    is then off: one CPU). A mesh must start on ``device``, where the run's
    small operands and the joins live."""
    if isinstance(mesh, str):
        dev = torch.device(device)
        parsed = parse_spec(mesh)
        if dev.type == "cpu":
            mesh = None if parsed in (None, "auto") else make_plane_mesh(
                parsed[0], dim_shards=parsed[1], devices=[dev] * (parsed[0] * parsed[1]))
        else:
            mesh = mesh_from_spec(mesh)
    if mesh is not None and mesh.first_device != torch.device(device):
        raise ValueError(f"the mesh starts on {mesh.first_device}, the run is on {device}")
    return mesh



# ------------------------------------------------------------- model meshes
@dataclasses.dataclass(frozen=True)
class ModelMesh:
    """A grid of devices over ``axis_names`` (``data`` and ``model``, with
    ``pod`` first on a multipod mesh). ``devices`` lists them row-major over
    the axes, so the device of batch shard ``b`` (``pod`` and ``data``
    flattened, ``pod`` major) and model rank ``m`` is ``devices[b * M + m]``.
    A device may appear several times."""

    axis_names: tuple[str, ...]
    extents: tuple[int, ...]
    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> extent, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.extents))

    @property
    def size(self) -> int:
        return math.prod(self.extents)

    @property
    def first_device(self) -> torch.device:
        return self.devices[0]

    def device(self, batch_shard: int, rank: int) -> torch.device:
        """The device of batch shard ``batch_shard`` and model rank ``rank``."""
        return self.devices[batch_shard * axis_size(self, "model") + rank]

    def __repr__(self) -> str:
        return f"ModelMesh({self.shape}, {sorted({str(d) for d in self.devices})})"


def _model_mesh(extents: tuple[int, ...], axes: tuple[str, ...],
                devices: Sequence[torch.device | str] | None) -> ModelMesh:
    devs = [torch.device(d) for d in (_cards() if devices is None else devices)]
    need = math.prod(extents)
    if len(devs) < need:
        raise ValueError(f"a {' x '.join(map(str, extents))} mesh needs {need} devices, "
                         f"{len(devs)} {'visible cards' if devices is None else 'given'}")
    return ModelMesh(axes, extents, tuple(devs[:need]))


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Sequence[torch.device | str] | None = None) -> ModelMesh:
    """The pod mesh, 16 x 16 over ``("data", "model")``, or with
    ``multi_pod`` 2 x 16 x 16 over ``("pod", "data", "model")``, taken in
    order from ``devices`` (default: every visible card)."""
    if multi_pod:
        return _model_mesh((2, 16, 16), ("pod", "data", "model"), devices)
    return _model_mesh((16, 16), ("data", "model"), devices)


def make_smoke_mesh(devices: Sequence[torch.device | str] | None = None) -> ModelMesh:
    """A 1 x 1 mesh with the production axis names: the one-device path."""
    return _model_mesh((1, 1), ("data", "model"), devices)


def resolve_model_mesh(name: str, device: torch.device | str) -> ModelMesh:
    """The drivers' ``--mesh smoke|pod|multipod`` over the visible cards, or
    on the CPU over the one ``cpu`` device repeated."""
    dev = torch.device(device)
    multi = name == "multipod"
    if name not in ("smoke", "pod", "multipod"):
        raise KeyError(name)
    need = 1 if name == "smoke" else 512 if multi else 256
    devices = [dev] * need if dev.type == "cpu" or name == "smoke" else None
    if name == "smoke":
        return make_smoke_mesh(devices)
    return make_production_mesh(multi_pod=multi, devices=devices)


def batch_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1

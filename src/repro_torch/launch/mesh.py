"""Mesh specs for the sharded serve (`serve --mesh SPEC`), and their
placement on cards.

The reference builds JAX meshes of real or mocked devices
(`repro.launch.mesh`). Here a mesh is small data — its shape, its axis
names, the device and, once placed, the rank's `Placement` — read by
`mesh_axes` as the reference's is.

Without a process group, `host:N` gives N model-axis shards of the reuse
cache and the weight panels on the serve's one device (each shard runs its
own kernels), the counterpart of the reference's N mocked host devices.
Under a process group (`torchrun --nproc-per-node N`, one process a card:
`start_process_group`), `place_mesh` gives rank r model-axis shard `r % S`,
in the reference's row-major (data, model) device order, and the process
group of its data row's model axis. The production pods (256 and 512
cards) raise.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from repro_torch.dist.shard import Placement

# the backend each device's process group runs, named explicitly: NCCL on
# the card, gloo only on the CPU
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh as the serve reads it: axis sizes by name, in order,
    the device its shard lanes live on, and, placed under a process group,
    the rank's place (None: every lane on that one device)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    device: str = "cuda"
    placement: Placement | None = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16x16 pod (256 chips) or 2x16x16 (512)."""
    chips = 512 if multi_pod else 256
    raise NotImplementedError(
        f"mesh {'prod-pod' if multi_pod else 'prod'} needs {chips} cards, one "
        f"process a card under a process group of {chips} ranks — use "
        "'host:N' with N ranks (torchrun --nproc-per-node N), or without a "
        "process group for N shard lanes on the serve's one device")


def make_host_mesh(n_devices: int, model_size: int | None = None, *,
                   device: str = "cuda") -> Mesh:
    """("data", "model") with the model axis `model_size` wide (default:
    every device on the model axis). The data axis replicates, as in the
    reference's serve, so only the model axis shapes the cache."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if model_size is None:
        model_size = n_devices
    if model_size < 1 or n_devices % model_size:
        raise ValueError(
            f"model_size={model_size} must divide n_devices={n_devices} "
            f"(mesh shape is (data={n_devices}//{model_size}, "
            f"model={model_size}))"
        )
    return Mesh(("data", "model"), (n_devices // model_size, model_size),
                device)


def parse_mesh_spec(spec: str, *, device: str = "cuda") -> Mesh:
    """Mesh from a CLI spec string.

    "host:N"    — N shards, all on the model axis
    "host:N@S"  — N shards, model axis S wide (data axis N/S, replicated)
    "prod"      — the 16x16 production pod (raises: 256 cards)
    "prod-pod"  — 2x16x16 multi-pod (raises: 512 cards)
    """
    s = spec.strip().lower()
    if s == "prod":
        return make_production_mesh()
    if s in ("prod-pod", "prod:pod"):
        return make_production_mesh(multi_pod=True)
    if s.startswith("host:"):
        body = s[len("host:"):]
        model: int | None = None
        if "@" in body:
            body, model_s = body.split("@", 1)
            try:
                model = int(model_s)
            except ValueError:
                raise ValueError(
                    f"bad mesh spec {spec!r}: model size {model_s!r} is not "
                    "an integer") from None
        try:
            n = int(body)
        except ValueError:
            raise ValueError(
                f"bad mesh spec {spec!r}: device count {body!r} is not an "
                "integer") from None
        return make_host_mesh(n, model, device=device)
    raise ValueError(
        f"unknown mesh spec {spec!r} — expected 'host:N', 'host:N@S', "
        "'prod', or 'prod-pod'"
    )


def start_process_group(device: str) -> tuple[int, int, torch.device] | None:
    """The process group of a launch by `torchrun` (RANK, WORLD_SIZE and
    LOCAL_RANK in the environment), started unless a caller started it:
    NCCL for `device` "cuda", with each rank on `cuda:LOCAL_RANK`; gloo for
    "cpu". Returns (rank, world size, the rank's device), or None when no
    group is up and no launcher set the environment. A rank that finds no
    card of its own raises, and so does a group already up on another
    backend than the device's: nothing changes backend on its own."""
    import torch.distributed as dist

    backend = BACKENDS[device]
    started = dist.is_available() and dist.is_initialized()
    if started:
        rank, world = dist.get_rank(), dist.get_world_size()
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"the process group runs {dist.get_backend()!r} but --device "
                f"{device} needs {backend!r}")
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        return None
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= cards:
            raise RuntimeError(
                f"rank {rank} (local rank {local}) finds no card cuda:{local}:"
                f" {cards} visible")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if not started:
        dist.init_process_group(backend=backend, rank=rank, world_size=world)
    return rank, world, dev


def place_mesh(mesh: Mesh, rank: int, world: int,
               device: torch.device) -> Mesh:
    """`mesh` placed one process a card: rank `rank` of `world` holds
    model-axis shard `rank % S` of data row `rank // S`, and all-gathers
    over that row's model group (made here, by every rank, in row order;
    the default group when the model axis spans the world)."""
    import torch.distributed as dist

    n = math.prod(mesh.sizes)
    if world != n:
        raise RuntimeError(
            f"mesh wants {n} devices but the process group has {world} "
            f"ranks — launch one process a card with torchrun "
            f"--nproc-per-node {n}")
    model = mesh.shape["model"]
    group = None
    if model != world:
        for row in range(world // model):
            g = dist.new_group(list(range(row * model, (row + 1) * model)))
            if row == rank // model:
                group = g
    return dataclasses.replace(mesh, device=str(device), placement=Placement(
        rank=rank, world=world, n_shards=model, group=group, device=device))


def mesh_axes(mesh: Mesh) -> dict:
    """Role map for the sharding rules."""
    names = mesh.axis_names
    dp_axes = tuple(a for a in names if a in ("pod", "data"))
    return {
        "dp_axes": dp_axes,
        "data_size": math.prod(mesh.shape[a] for a in dp_axes) if dp_axes else 1,
        "model_axis": "model",
        "model_size": mesh.shape["model"],
    }

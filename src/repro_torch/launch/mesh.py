"""Mesh specs for the sharded serve (`serve --mesh SPEC`).

The reference builds JAX meshes of real or mocked devices
(`repro.launch.mesh`). Here a mesh is small data — its shape, its axis
names and the one device the serve runs on — read by `mesh_axes` as the
reference's is. `host:N` gives N model-axis shards of the reuse cache and
the weight panels on that device (each shard runs its own kernels), the
counterpart of the reference's N mocked host devices. One shard a card
(one process a card, `torch.distributed`) is not ported, and the
production pods raise.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh as the serve reads it: axis sizes by name, in order,
    and the device every shard lane lives on."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    device: str = "cuda"

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16x16 pod (256 chips) or 2x16x16 (512): not placed
    here, which runs every shard on one device."""
    chips = 512 if multi_pod else 256
    raise NotImplementedError(
        f"mesh {'prod-pod' if multi_pod else 'prod'} needs {chips} cards, one "
        "shard a card; placing shards on several cards (one process a card, "
        "torch.distributed) is not ported — use 'host:N' for N shard lanes on "
        "the serve's one device")


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

    "host:N"    — N shard lanes, all on the model axis
    "host:N@S"  — N lanes, model axis S wide (data axis N/S, replicated)
    "prod"      — the 16x16 production pod (raises: not placed here)
    "prod-pod"  — 2x16x16 multi-pod (raises)
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

"""Device mesh.

Counterpart of ``mxnet_tpu/parallel/mesh.py:21``: named axes (dp, pp, tp,
sp, ep) over the devices present, with the same validation and canonical
axis order. The devices are Contexts: the CUDA cards by default, or the
CPU inside ``with mx.cpu():`` (or ``devices=[mx.cpu()]``). Only meshes of
one device run in this slice; a mesh over more devices (NCCL data
parallelism, tensor parallelism) raises :class:`MXNetError`.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..base import MXNetError
from ..context import Context, current_context, gpu, num_gpus

__all__ = ["DeviceMesh"]

AXIS_ORDER = ("dp", "pp", "tp", "sp", "ep")


class DeviceMesh:
    """A named-axis mesh over devices (Contexts).

    ``DeviceMesh()`` puts every card on the dp axis;
    ``DeviceMesh({"dp": 1})`` takes the first card.
    """

    def __init__(self, axes: Optional[Dict[str, int]] = None, devices=None):
        if devices is None:
            if current_context().device_type == "cpu":
                devices = [current_context()]
            else:
                devices = [gpu(i) for i in range(num_gpus())]
                if not devices:
                    raise MXNetError(
                        "DeviceMesh needs a CUDA card but none is visible; "
                        "pass devices=[mx.cpu()] (or build it inside "
                        "`with mx.cpu():`) to run on the CPU")
        self.devices = [Context(d) for d in devices]
        n = len(self.devices)
        sizes = dict(axes) if axes is not None else {"dp": n}
        for a, v in sizes.items():
            if not isinstance(a, str) or not a:
                raise ValueError(
                    f"mesh axis names must be non-empty strings, got "
                    f"{a!r}; conventional axes: {list(AXIS_ORDER)}")
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"mesh axis {a!r} must have a positive integer size, "
                    f"got {v!r}")
        prod = 1
        for v in sizes.values():
            prod *= v
        if prod > n:
            raise ValueError(
                f"mesh axes {sizes} require {prod} devices, have {n}")
        if prod > 1:
            raise MXNetError(
                f"mesh axes {sizes} span {prod} devices: multi-device "
                "meshes (NCCL data parallelism, tensor parallelism) are not "
                "ported yet; see ROADMAP.md section A")
        self.devices = self.devices[:prod]  # smaller meshes use a prefix
        self.axis_names = tuple(a for a in AXIS_ORDER if a in sizes) + tuple(
            a for a in sizes if a not in AXIS_ORDER)
        self.axis_sizes = {a: sizes[a] for a in self.axis_names}

    def size(self, axis: str) -> int:
        return self.axis_sizes.get(axis, 1)

    def axis_error(self, axis) -> str:
        """The diagnostic for an axis this mesh does not have: a
        did-you-mean hint and the valid axes (``mxnet_tpu/parallel/
        mesh.py:72``). The trainer's sharding rules and ``resume``'s
        topology check name axes through it."""
        from ..base import did_you_mean

        return (f"axis {axis!r} is not an axis of this mesh"
                f"{did_you_mean(axis, self.axis_names)}; valid axes: "
                f"{list(self.axis_names)}")

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    @property
    def device(self):
        """The ``torch.device`` of the mesh's only device."""
        return self.devices[0].torch_device()

    def describe(self):
        """JSON-able topology record (axis sizes, device count), written
        into checkpoint manifests as the JAX package writes it."""
        return {"axes": dict(self.axis_sizes),
                "num_devices": self.num_devices, "process_indices": [0]}

    def __repr__(self):
        return f"DeviceMesh({self.axis_sizes})"


# Port of repro/launch/mesh.py: the production meshes as torch DeviceMeshes.
"""Production mesh construction.

Functions, not module-level constants, so importing this module touches no
process group and no device.  Both need an initialised default process
group whose world size is the mesh's size: 256 ranks for the (16, 16)
``data x model`` mesh, 512 for the (2, 16, 16) ``pod x data x model`` one.
The meshes live on the card unless the caller passes ``device_type="cpu"``
(the tests, under torch's fake or ``gloo`` process groups).
"""

from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape, axes, device_type="cuda"):
    """Arbitrary mesh for tests and examples, e.g. (2, 2) on ``gloo``
    ranks or (1, 1) on one card."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))

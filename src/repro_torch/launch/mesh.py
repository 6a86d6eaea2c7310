"""Mesh construction (a port of ``repro.launch.mesh``): functions, not
module-level constants, so importing this module touches no device.

Every factory takes ``devices=``: one device a position (row-major over
the mesh's axes), or one device for all of them; None puts every position
on the entry point's default device (CUDA unless ``"cpu"`` is passed).  On
a one-card machine every position is that card.
"""
from __future__ import annotations

from ..models.sharding import ModelMesh


def make_production_mesh(*, multi_pod: bool = False, devices=None
                         ) -> ModelMesh:
    """The reference's TPU v5e pod layout: (data 16, model 16), or (pod
    2, data 16, model 16) with ``multi_pod``."""
    if multi_pod:
        return ModelMesh((2, 16, 16), ("pod", "data", "model"), devices)
    return ModelMesh((16, 16), ("data", "model"), devices)


def make_smoke_mesh(*, devices=None) -> ModelMesh:
    """The (1, 1, 1) mesh: the mesh code paths with every collective over
    one position."""
    return ModelMesh((1, 1, 1), devices=devices)


def make_mesh_for(n_devices: int, *, model_parallel: int = 16,
                  devices=None) -> ModelMesh:
    """The reference's factorisation of ``n_devices`` positions into
    (pod, data, model): the widest ``model`` up to ``model_parallel`` that
    divides it, then two pods where the rest is even and at least 32."""
    model = min(model_parallel, n_devices)
    while n_devices % model:
        model -= 1
    rest = n_devices // model
    pod = 2 if rest % 2 == 0 and rest >= 32 else 1
    return ModelMesh((pod, rest // pod, model), devices=devices)

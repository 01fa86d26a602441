"""Launchers: batched LM serving and training, and the device meshes the
simulator's sharded entries run on (``launch.mesh``)."""

from repro_torch.launch.mesh import (
    WorldError, make_local_mesh, make_production_mesh, mesh_device,
    mesh_num_devices, rank_device, spawn_world,
)

__all__ = ["WorldError", "make_local_mesh", "make_production_mesh",
           "mesh_device", "mesh_num_devices", "rank_device", "spawn_world"]

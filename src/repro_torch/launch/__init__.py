"""Device meshes for the data-parallel paths (``launch.mesh``)."""
from repro_torch.launch.mesh import dp_axes, make_dp_mesh, make_mesh_compat  # noqa: F401

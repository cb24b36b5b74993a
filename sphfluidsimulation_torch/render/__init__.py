"""Render path: per-instance mesh properties (on the device of the state),
the octahedron-sphere particle mesh, the orbit camera, and host-side frame
export (PNG, PLY, animation, a standalone WebGL viewer).

Counterpart of ``sphfluidsimulation_tpu/render``. Replaces the reference's
GPU render stack (UpdateMeshProperties.compute → MeshProperties structured
buffer → Graphics.DrawMeshInstancedIndirect with
InstancedIndirectColor.shader) with a properties pass plus host-side
image and mesh export: frames are written as files, not drawn to a
swapchain.
"""

from .meshprops import RenderParams, mesh_properties, speed_colors  # noqa: F401
from .sphere import octahedron_sphere  # noqa: F401
from .camera import OrbitCamera  # noqa: F401
from .export import render_frame_png, save_png, save_ply  # noqa: F401

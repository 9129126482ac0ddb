"""Multi-device execution: the mesh, the sharded MSM engine, and the
torch.distributed entry for several processes."""

from .mesh import Mesh, ShardedMsmEngine, make_mesh  # noqa: F401

from .shard import make_mesh, render_sharded, sharded_render_frame  # noqa: F401

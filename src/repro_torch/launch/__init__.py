"""Device meshes of the port: ``mesh.make_sweep_mesh``, the 1-D mesh
that campaign point batches shard their lanes over."""

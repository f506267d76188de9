"""Multi-device matching: frame-parallel and index-parallel meshes, and the
multi-host frame shard and gather (``parallel/mesh.py``)."""

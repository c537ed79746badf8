from .relax_tiled import relax_compact_tiled              # noqa: F401

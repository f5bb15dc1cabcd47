"""One driver per entry point of the port: ``setup(ctx) -> Run`` and ``tiny(cell) -> cell``."""

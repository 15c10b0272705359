"""Serving runtime (port of ``repro.runtime``'s serving loop)."""
from repro_torch.runtime.serve_loop import (  # noqa: F401
    BatchedServer, Request, RequestQueue, ServeStats)

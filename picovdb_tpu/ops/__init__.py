"""Device-side compute ops: exact scan, quantized formats, IVF probe."""

from .exact import exact_topk, make_exact_topk  # noqa: F401

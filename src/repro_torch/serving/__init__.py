from .engine import (  # noqa: F401
    Request,
    RequestResult,
    ServingEngine,
    TraceResult,
    make_decode_fn,
    make_prefill_fn,
    serve_trace,
)

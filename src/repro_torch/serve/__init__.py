from .cache import ServeConfig
from .decode import ServeEngine, build_serve_engine, make_generator, serve_generate
from .scheduler import Request, ServeScheduler
from .state import ServeState, make_serve_state

__all__ = [
    "ServeConfig", "ServeEngine", "ServeState", "ServeScheduler", "Request",
    "build_serve_engine", "make_generator", "serve_generate",
    "make_serve_state",
]

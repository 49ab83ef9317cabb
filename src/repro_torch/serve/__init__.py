from .cache import HotBlockCache, ServeConfig, build_cache
from .decode import (ServeEngine, build_serve_engine, generate,
                     make_generator, serve_from_compressed, serve_generate)
from .delta import (ServeDelta, apply_delta, apply_word_delta,
                    delta_flipped_windows, delta_report, lanes_delta,
                    make_delta, word_delta)
from .scheduler import Request, ServeScheduler
from .state import ServeState, make_serve_state, reconstruct_resident

__all__ = [
    "ServeEngine", "ServeState", "ServeDelta",
    "ServeConfig", "HotBlockCache", "build_cache",
    "ServeScheduler", "Request",
    "build_serve_engine", "make_generator", "generate",
    "serve_generate", "serve_from_compressed",
    "make_serve_state", "reconstruct_resident",
    "make_delta", "apply_delta", "delta_report",
    "delta_flipped_windows",
    "word_delta", "apply_word_delta", "lanes_delta",
]

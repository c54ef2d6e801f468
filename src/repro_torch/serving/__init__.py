from .engine import Engine, ServeResult

from .logger import Logger  # noqa: F401

from .polish_model import PolisherConfig, PolisherType  # noqa: F401

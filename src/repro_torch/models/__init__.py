from .registry import ModelApi, get_model  # noqa: F401

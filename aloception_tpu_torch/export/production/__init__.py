from .model_handler import ModelHandler  # noqa: F401

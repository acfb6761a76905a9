"""Llama forward pass, GGUF loader and parameter conversion."""

from .config import ModelConfig  # noqa: F401
from .convert import params_from_numpy  # noqa: F401
from .loader import load_model  # noqa: F401

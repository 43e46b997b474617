from .bridge import load_jax_cache, load_jax_params
from .model import Model, ModelOutput, segmentize

__all__ = ["Model", "ModelOutput", "load_jax_cache", "load_jax_params", "segmentize"]

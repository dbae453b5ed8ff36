"""Model configurations."""
from .transformer import TransformerConfig

__all__ = ["TransformerConfig"]

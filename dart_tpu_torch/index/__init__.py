from .builder import build_index
from .loader import Index, load_index

__all__ = ["build_index", "Index", "load_index"]

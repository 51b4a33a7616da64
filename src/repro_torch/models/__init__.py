"""Model substrate: layers, the six families' models and the uniform Model API."""
from repro_torch.models.model import Model, cell_status, get_model

__all__ = ["Model", "cell_status", "get_model"]

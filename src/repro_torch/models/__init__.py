"""Model substrate: layers, the dense transformer and the uniform Model API."""
from repro_torch.models.model import Model, cell_status, get_model

__all__ = ["Model", "cell_status", "get_model"]

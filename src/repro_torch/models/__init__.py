from repro_torch.models.model import LM, build_model

__all__ = ["LM", "build_model"]

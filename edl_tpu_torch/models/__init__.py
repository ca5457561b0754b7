"""Model zoo of the port (the transformer LM so far)."""

from __future__ import annotations


def get_model(name: str):
    """Resolve a zoo factory by name (mirror of ``edl_tpu.models.get_model``)."""
    if name in ("Transformer", "TransformerConfig"):
        from edl_tpu_torch.models import transformer
        return getattr(transformer, name)
    raise AttributeError(f"unknown model {name!r}")

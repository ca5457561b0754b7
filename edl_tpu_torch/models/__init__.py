"""Model zoo of the port: the transformer LM, the ResNet family, the
MLP and the text classifiers of the distill examples, and the
linear-regression smoke model."""

from __future__ import annotations

import importlib

_ZOO = {
    "transformer": ("Transformer", "TransformerConfig"),
    "resnet": ("ResNet", "ResNet50", "ResNet101", "ResNet152",
               "ResNet50_vd", "ResNet101_vd", "ResNet152_vd", "ResNetTiny",
               "BottleneckBlock"),
    "linear": ("LinearRegression",),
    "mlp": ("MLP", "mlp"),
    "bow": ("BOWClassifier", "CNNClassifier"),
}


def get_model(name: str):
    """Resolve a zoo factory by name (mirror of ``edl_tpu.models.get_model``)."""
    for module, names in _ZOO.items():
        if name in names:
            mod = importlib.import_module(f"edl_tpu_torch.models.{module}")
            return getattr(mod, name)
    raise AttributeError(f"unknown model {name!r}")

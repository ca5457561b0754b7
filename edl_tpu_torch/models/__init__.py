"""Model zoo of the port: the transformer LM, the ResNet and VGG
families, the MLP and the text classifiers of the distill examples,
DeepFM for CTR, and the linear-regression smoke model: every name of
``edl_tpu.models``."""

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
    "vgg": ("VGG", "VGG11", "VGG13", "VGG16", "VGG19"),
    "deepfm": ("DeepFM",),
}


def get_model(name: str):
    """Resolve a zoo factory by name (mirror of ``edl_tpu.models.get_model``)."""
    for module, names in _ZOO.items():
        if name in names:
            mod = importlib.import_module(f"edl_tpu_torch.models.{module}")
            return getattr(mod, name)
    raise AttributeError(f"unknown model {name!r}")

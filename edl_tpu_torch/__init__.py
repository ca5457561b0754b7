"""PyTorch/CUDA port of edl_tpu, built slice by slice beside the JAX package.

Module paths mirror ``edl_tpu``'s, so each counterpart is found under the
same name. The package imports torch and numpy, never jax or anything of
``edl_tpu``: where it needs a jax-free helper of the JAX package it keeps
its own trimmed copy. Entry points run on CUDA unless the caller passes
``device="cpu"``; asking for CUDA where there is none raises. The
package itself imports torch only where it is used, so the elastic
launcher and the store (``collective/``, ``coord/``) start without it.
"""

from __future__ import annotations


def resolve_device(device="cuda"):
    """``device`` (a str or torch.device) as a torch.device; raises when
    CUDA is asked for and absent (never a quiet move to the CPU)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

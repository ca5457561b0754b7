"""Teacher predict function over one device (port of
``edl_tpu.distill.sharded_teacher.sharded_predict_fn``; the mesh, its
sharded parameters and the dp padding come with the multi-GPU slice).

``serve_topk`` runs ``torch.topk`` on the device, over the last axis,
and packs (idx bits, values) into ONE fp32 tensor, so each batch pays a
single device->host copy. The predict function only launches work; it
returns a callable that fetches (dense logits, or the top-k pair) to
host numpy. The teacher server's complete stage calls it, so the
compute thread is already feeding the next batch:

    model = Transformer(cfg, device="cuda")
    predict, meta = sharded_predict_fn(lambda m, x: m(x), model,
                                       input_key="tokens",
                                       serve_topk=16, classes=cfg.vocab_size)
    TeacherServer(predict, compressed_meta=meta).start()
"""

from __future__ import annotations

import numpy as np
import torch

from edl_tpu_torch import resolve_device
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.distill.sharded_teacher")


def sharded_predict_fn(apply_fn, variables, device: str | torch.device =
                       "cuda", *,
                       input_key: str = "image",
                       output_key: str = "logits",
                       input_dtype=None,
                       serve_topk: int = 0,
                       classes: int | None = None):
    """Build a `TeacherServer` predict_fn on ``device``.

    apply_fn(variables, x) -> logits (any rank; classes on the LAST
    axis); ``variables`` is typically the ``nn.Module`` itself, moved to
    ``device`` here when it is one. Returns ``(predict, compressed_meta)``
    — meta is None without ``serve_topk``, else the announcement
    TeacherServer attaches so dense clients scatter-expand transparently.
    The forward runs under ``torch.inference_mode``, entered by predict
    itself on the calling (compute) thread.
    """
    dev = resolve_device(device)
    if serve_topk and classes is None:
        raise ValueError("serve_topk needs `classes` (the dense width) "
                         "for the client-side expansion announcement")
    if serve_topk and serve_topk > classes:
        # torch.topk rejects k > axis size: clamp instead of failing on
        # the first predict
        log.warning("serve_topk %d > %d classes; clamping", serve_topk,
                    classes)
        serve_topk = int(classes)
    if isinstance(variables, torch.nn.Module):
        variables = variables.to(dev).eval()

    def predict(feeds: dict):
        x = np.asarray(feeds[input_key])
        if input_dtype is not None:
            x = x.astype(input_dtype)
        with torch.inference_mode():
            logits = apply_fn(variables,
                              torch.as_tensor(x, device=dev)).float()
            if serve_topk:
                val, idx = torch.topk(logits, serve_topk, dim=-1)
                packed = torch.cat(
                    [idx.to(torch.int32).view(torch.float32), val], dim=-1)

        def fetch() -> dict:
            if not serve_topk:
                return {output_key: logits.cpu().numpy()}
            out = packed.cpu().numpy()
            idx_np = np.ascontiguousarray(out[..., :serve_topk]).view(np.int32)
            val_np = out[..., serve_topk:].astype(np.float16)
            return {output_key + ".idx": idx_np,
                    output_key + ".val": val_np}

        return fetch

    meta = None
    if serve_topk:
        meta = {output_key: {"topk": serve_topk, "classes": int(classes),
                             "values": "<f2"}}
    log.info("teacher predict on %s (serve_topk %d)", dev, serve_topk)
    return predict, meta

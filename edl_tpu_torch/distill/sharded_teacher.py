"""Teacher serving over every local card from one process (port of
``edl_tpu.distill.sharded_teacher``).

The JAX package jits the teacher forward over a local mesh: the batch
splits over the data axes and XLA places each share on its chip. Here
one process holds one eval replica of the module per device and, per
request, pads the rows to a multiple of the device count with zeros,
launches each device's share (the launches are asynchronous, so the
cards run together) and fetches each share's output, dropping the pad
rows. Data-parallel inference needs no collective, so this is no world
of ranks and joins no process group. One device is the same path with
one share. A tensor-parallel (``tp``) teacher, whose parameters no
single card holds, is not ported: ``parse_local_mesh`` refuses it,
naming ROADMAP Queue 1 item 14.

``serve_topk`` runs ``torch.topk`` on the device, over the last axis,
and packs (idx bits, values) into ONE fp32 tensor, so each share pays a
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

import copy
from typing import Sequence

import numpy as np
import torch

from edl_tpu_torch import resolve_device
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.distill.sharded_teacher")

BATCH_AXES = ("dp", "fsdp")


def parse_local_mesh(spec: str, device: str | torch.device = "cuda"
                     ) -> list[torch.device]:
    """``"dp=4"`` -> the local devices one teacher process drives: the
    product of the data axes' sizes (dp, fsdp), ``cuda:0`` up (raises
    when the host has fewer cards), or that many CPU replicas with
    ``device="cpu"``. Any other axis above size 1 (tp, sp, ...) raises
    NotImplementedError naming ROADMAP Queue 1 item 14."""
    axes = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        axes[name.strip()] = int(size)
    others = [a for a, n in axes.items() if a not in BATCH_AXES and n > 1]
    if others:
        raise NotImplementedError(
            f"a local mesh over {others} (a sharded teacher) is not ported "
            "yet (ROADMAP Queue 1 item 14); serve with dp only")
    n = int(np.prod([axes.get(a, 1) for a in BATCH_AXES]))
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"--local-mesh {spec!r} asks for {n} cards; this "
                         f"host has {have}")
    return [torch.device("cuda", i) for i in range(n)]


def sharded_predict_fn(apply_fn, variables, device: str | torch.device =
                       "cuda", *,
                       devices: Sequence | None = None,
                       input_key: str = "image",
                       output_key: str = "logits",
                       input_dtype=None,
                       serve_topk: int = 0,
                       classes: int | None = None):
    """Build a `TeacherServer` predict_fn on ``device``, or over
    ``devices`` (one replica each; see the module docstring).

    apply_fn(variables, x) -> logits (any rank; classes on the LAST
    axis); ``variables`` is typically the ``nn.Module`` itself, moved
    (and, over several devices, copied) to each device here. Returns
    ``(predict, compressed_meta)`` — meta is None without ``serve_topk``,
    else the announcement TeacherServer attaches so dense clients
    scatter-expand transparently. The forward runs under
    ``torch.inference_mode``, entered by predict itself on the calling
    (compute) thread.
    """
    devs = [resolve_device(d) for d in (devices or [device])]
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
        replicas = [variables.to(devs[0]).eval()]
        replicas += [copy.deepcopy(variables).to(d).eval() for d in devs[1:]]
    else:
        replicas = [variables] * len(devs)

    def launch(replica, dev, x: np.ndarray) -> torch.Tensor:
        logits = apply_fn(replica, torch.as_tensor(x, device=dev)).float()
        if not serve_topk:
            return logits
        val, idx = torch.topk(logits, serve_topk, dim=-1)
        return torch.cat([idx.to(torch.int32).view(torch.float32), val],
                         dim=-1)

    def predict(feeds: dict):
        x = np.asarray(feeds[input_key])
        if input_dtype is not None:
            x = x.astype(input_dtype)
        rows = x.shape[0]
        pad = (-rows) % len(devs)
        if pad:
            x = np.concatenate(
                [x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
        with torch.inference_mode():
            outs = [launch(r, d, share) for r, d, share in
                    zip(replicas, devs, np.split(x, len(devs)))]

        def fetch() -> dict:
            out = np.concatenate([o.cpu().numpy() for o in outs])[:rows]
            if not serve_topk:
                return {output_key: out}
            idx_np = np.ascontiguousarray(out[..., :serve_topk]).view(np.int32)
            val_np = out[..., serve_topk:].astype(np.float16)
            return {output_key + ".idx": idx_np,
                    output_key + ".val": val_np}

        return fetch

    meta = None
    if serve_topk:
        meta = {output_key: {"topk": serve_topk, "classes": int(classes),
                             "values": "<f2"}}
    log.info("teacher predict on %s (serve_topk %d)",
             ", ".join(map(str, devs)), serve_topk)
    return predict, meta

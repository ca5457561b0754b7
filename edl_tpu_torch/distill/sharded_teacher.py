"""Teacher serving over every local card from one process (port of
``edl_tpu.distill.sharded_teacher``).

The JAX package jits the teacher forward over a local mesh: the batch
splits over the data axes, the parameters land tp-sharded by the model's
logical axes (how a teacher larger than one chip is served at all) and
XLA places each share on its chip. Here one process holds one eval
replica of the module per data-parallel group and, per request, pads the
rows to a multiple of the groups with zeros, launches each group's share
(the launches are asynchronous, so the cards run together) and fetches
each share's output, dropping the pad rows. One device is the same path
with one share.

A ``tp`` axis splits each group over tp shards: ``parallel/sharding.
shard_module`` cuts a copy of the transformer for each (its heads, MLP
columns, vocab rows and token-table columns), each shard runs in its own
thread on its own device (``devices`` may repeat one: two shards on
``cuda:0`` run the whole sharded path on one card), and the model's tp
layers meet at a ``parallel/distributed.LocalComm``, which adds the
partial sums in shard order so every shard holds the same bits. Dense
logits are gathered from tp. Under ``serve_topk`` each shard takes the
top-k of its vocab slice and these merge into the global top-k with
global indices, ties to the lower index as ``lax.top_k`` breaks them
(:func:`topk_lower_first`, :func:`merge_topk`). A sequence-parallel
(``sp``) teacher is not ported: ``local_mesh_axes`` refuses it, naming
ROADMAP Queue 1 item 14(d).

``serve_topk`` packs (idx bits, values) into ONE fp32 tensor, so each
share pays a single device->host copy. The predict function only
launches work; it returns a callable that fetches (dense logits, or the
top-k pair) to host numpy. The teacher server's complete stage calls it,
so the compute thread is already feeding the next batch:

    model = Transformer(cfg, device="cuda")
    predict, meta = sharded_predict_fn(lambda m, x: m(x), model,
                                       input_key="tokens",
                                       serve_topk=16, classes=cfg.vocab_size)
    TeacherServer(predict, compressed_meta=meta).start()

and over two tp shards of one card:

    predict, meta = sharded_predict_fn(
        lambda m, x: m(x), model, devices=["cuda:0", "cuda:0"],
        mesh={"dp": 1, "tp": 2}, input_key="tokens", serve_topk=16,
        classes=cfg.vocab_size)
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from threading import BrokenBarrierError
from typing import Sequence

import numpy as np
import torch

from edl_tpu_torch import resolve_device
from edl_tpu_torch.parallel.mesh import DATA_AXES
from edl_tpu_torch.parallel.mesh import TP_AXIS
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.distill.sharded_teacher")


def local_mesh_axes(spec: str | dict) -> dict[str, int]:
    """``"dp=4,tp=2"`` (or such a dict) -> its axis sizes. An axis other
    than dp, fsdp and tp above size 1 (a sequence-parallel teacher)
    raises NotImplementedError naming ROADMAP Queue 1 item 14(d)."""
    if isinstance(spec, dict):
        axes = {k: int(v) for k, v in spec.items()}
    else:
        axes = {}
        for part in spec.split(","):
            name, _, size = part.partition("=")
            axes[name.strip()] = int(size)
    others = [a for a, n in axes.items()
              if a not in DATA_AXES + (TP_AXIS,) and n > 1]
    if others:
        raise NotImplementedError(
            f"a local mesh over {others} (a sequence-parallel teacher) is "
            "not ported yet (ROADMAP Queue 1 item 14(d)); serve with dp "
            "and tp")
    return axes


def parse_local_mesh(spec: str, device: str | torch.device = "cuda"
                     ) -> list[torch.device]:
    """``"dp=4"`` -> the local devices one teacher process drives, one a
    mesh position (dp x fsdp x tp, tp minor): ``cuda:0`` up (raises when
    the host has fewer cards), or that many CPU replicas with
    ``device="cpu"``. An sp axis raises (:func:`local_mesh_axes`)."""
    axes = local_mesh_axes(spec)
    n = int(np.prod([axes.get(a, 1) for a in DATA_AXES + (TP_AXIS,)]))
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"--local-mesh {spec!r} asks for {n} cards; this "
                         f"host has {have}")
    return [torch.device("cuda", i) for i in range(n)]


def topk_lower_first(x: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the k largest values in
    descending order, and their indices, ties to the lower index (the
    elements equal to the k-th largest value that are kept are its
    lowest-indexed ones)."""
    n = x.shape[-1]
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    above = x > kth
    at = x == kth
    room = k - above.sum(dim=-1, keepdim=True)
    take = above | (at & (torch.cumsum(at, dim=-1, dtype=torch.int32)
                          <= room))
    # the kept positions, ascending: distinct keys n - pos (exact in fp32
    # for n < 2**24), so topk's order among them is fixed
    pos = torch.arange(n, 0, -1, device=x.device, dtype=torch.float32)
    idx = torch.topk(torch.where(take, pos, 0.0), k, dim=-1).indices
    val = torch.gather(x, -1, idx)
    order = torch.sort(val, dim=-1, descending=True, stable=True).indices
    return torch.gather(val, -1, order), torch.gather(idx, -1, order)


def merge_topk(vals: Sequence[torch.Tensor], idxs: Sequence[torch.Tensor],
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The global top-k from the shards' own (values, global indices):
    by value, ties to the lower index."""
    val, idx = torch.cat(list(vals), dim=-1), torch.cat(list(idxs), dim=-1)
    order = torch.sort(idx, dim=-1, stable=True).indices
    val, idx = torch.gather(val, -1, order), torch.gather(idx, -1, order)
    order = torch.sort(val, dim=-1, descending=True,
                       stable=True).indices[..., :k]
    return torch.gather(val, -1, order), torch.gather(idx, -1, order)


def _pack(val: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.cat([idx.to(torch.int32).view(torch.float32), val], dim=-1)


def _tp_shards(model: torch.nn.Module, devs: list, tp: int,
               vocab_local: bool) -> list[list]:
    """For each dp group, its tp shards of ``model``: (shard, device,
    exchange), each cut by ``shard_module`` over a ("dp", "tp") mesh
    whose tp group is the group's LocalComm."""
    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.parallel.mesh import Mesh
    from edl_tpu_torch.parallel.sharding import shard_module

    groups = len(devs) // tp
    grid = np.arange(groups * tp).reshape(groups, tp)
    out = []
    for g in range(groups):
        exchange = distributed.LocalExchange(tp)
        shards = []
        for t in range(tp):
            shard = copy.deepcopy(model)
            mesh = Mesh(grid, ("dp", TP_AXIS), rank=g * tp + t,
                        groups={TP_AXIS: distributed.LocalComm(exchange, t)})
            if not shard_module(shard, mesh):
                raise ValueError("a tp teacher shards a module whose "
                                 "parameters the rules split over tp (the "
                                 "transformer)")
            shard.vocab_local = vocab_local
            shards.append((shard.to(devs[g * tp + t]).eval(),
                           devs[g * tp + t], exchange))
        out.append(shards)
    return out


def sharded_predict_fn(apply_fn, variables, device: str | torch.device =
                       "cuda", *,
                       devices: Sequence | None = None,
                       mesh: str | dict | None = None,
                       input_key: str = "image",
                       output_key: str = "logits",
                       input_dtype=None,
                       serve_topk: int = 0,
                       classes: int | None = None):
    """Build a `TeacherServer` predict_fn on ``device``, or over
    ``devices`` (see the module docstring).

    apply_fn(variables, x) -> logits (any rank; classes on the LAST
    axis); ``variables`` is typically the ``nn.Module`` itself, moved
    (and, over several devices, copied) to each device here. ``mesh``
    (``{"dp": 1, "tp": 2}`` or ``"dp=1,tp=2"``) lays ``devices`` into
    data groups of tp shards, tp minor; without a tp axis every device
    is a data replica. Returns ``(predict, compressed_meta)`` — meta is
    None without ``serve_topk``, else the announcement TeacherServer
    attaches so dense clients scatter-expand transparently. The forward
    runs under ``torch.inference_mode``, entered by predict itself on the
    calling (compute) thread, or by each tp shard's thread.
    """
    devs = [resolve_device(d) for d in (devices or [device])]
    tp = local_mesh_axes(mesh).get(TP_AXIS, 1) if mesh is not None else 1
    if len(devs) % tp:
        raise ValueError(f"{len(devs)} devices do not split into tp "
                         f"groups of {tp}")
    if serve_topk and classes is None:
        raise ValueError("serve_topk needs `classes` (the dense width) "
                         "for the client-side expansion announcement")
    if serve_topk and serve_topk > classes:
        # torch.topk rejects k > axis size: clamp instead of failing on
        # the first predict
        log.warning("serve_topk %d > %d classes; clamping", serve_topk,
                    classes)
        serve_topk = int(classes)
    groups = len(devs) // tp
    if tp > 1:
        if not isinstance(variables, torch.nn.Module):
            raise ValueError("a tp teacher takes the module to shard")
        shards = _tp_shards(variables, devs, tp, bool(serve_topk))
        pool = ThreadPoolExecutor(max_workers=len(devs),
                                  thread_name_prefix="edl-tp-shard")

        def run_shard(shard, dev, exchange, t, x: np.ndarray):
            try:
                with torch.inference_mode():
                    logits = apply_fn(shard, torch.as_tensor(
                        x, device=dev)).float()
                    if not serve_topk:
                        return logits
                    n = logits.shape[-1]
                    val, idx = topk_lower_first(logits, min(serve_topk, n))
                    return val, idx + t * n
            except BaseException:
                exchange.abort()    # its peers raise instead of waiting
                raise

        def collect(group, futures) -> torch.Tensor:
            errors, outs = [], []
            for f in futures:
                try:
                    outs.append(f.result())
                except BaseException as exc:  # noqa: BLE001 — re-raised
                    errors.append(exc)
            if errors:
                group[0][2].reset()
                raise next((e for e in errors
                            if not isinstance(e, BrokenBarrierError)),
                           errors[0])
            if not serve_topk:
                return outs[0]        # every shard gathered the same logits
            dev = group[0][1]
            with torch.inference_mode():
                val, idx = merge_topk([v.to(dev) for v, _ in outs],
                                      [i.to(dev) for _, i in outs],
                                      serve_topk)
                return _pack(val, idx)

        def run_all(shares: list) -> list:
            launched = [(group, [pool.submit(run_shard, *shard, t, x)
                                 for t, shard in enumerate(group)])
                        for group, x in zip(shards, shares)]
            return [collect(group, futures) for group, futures in launched]
    else:
        def launch(replica, dev, x: np.ndarray) -> torch.Tensor:
            logits = apply_fn(replica, torch.as_tensor(x, device=dev)
                              ).float()
            if not serve_topk:
                return logits
            val, idx = torch.topk(logits, serve_topk, dim=-1)
            return _pack(val, idx)

        if isinstance(variables, torch.nn.Module):
            replicas = [variables.to(devs[0]).eval()]
            replicas += [copy.deepcopy(variables).to(d).eval()
                         for d in devs[1:]]
        else:
            replicas = [variables] * len(devs)

        def run_all(shares: list) -> list:
            with torch.inference_mode():
                return [launch(r, d, share) for r, d, share in
                        zip(replicas, devs, shares)]

    def predict(feeds: dict):
        x = np.asarray(feeds[input_key])
        if input_dtype is not None:
            x = x.astype(input_dtype)
        rows = x.shape[0]
        pad = (-rows) % groups
        if pad:
            x = np.concatenate(
                [x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
        outs = run_all(np.split(x, groups))

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
    log.info("teacher predict on %s (%d data groups of %d tp shards, "
             "serve_topk %d)", ", ".join(map(str, devs)), groups, tp,
             serve_topk)
    return predict, meta

"""Elastic knowledge-distillation pillar of the port (port of
``edl_tpu.distill``): student trainers pull teacher predictions over the
network from an elastic pool of inference servers, discovered and
load-balanced through the coordination store.

    teacher_server   — batched-inference server and the zoo-teacher CLI
    sharded_teacher  — one server process over every local card (dp)
    reader           — DistillReader: wraps a data reader, appends
                       teacher predictions (the three reference reader
                       formats too)
    registrar        — CLI registering a teacher under a service name
    discovery_server — balancer daemon: client <-> teacher assignment
    discovery_client — student-side registration, heartbeat, server cache
    balance          — the pure rebalance math

Every name below loads on first use, so the discovery daemon and the
registrar's store side start without numpy or torch.
"""

import importlib

_EXPORTS = {
    "ServiceBalance": "balance",
    "DistillReader": "reader",
    "EdlDistillError": "reader",
    "TeacherClient": "teacher_server",
    "TeacherServer": "teacher_server",
    "compress_outputs": "teacher_server",
    "expand_outputs": "teacher_server",
    "sharded_predict_fn": "sharded_teacher",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        # NOT `from edl_tpu_torch.distill import ...`: the fromlist
        # machinery would re-enter this __getattr__
        mod = importlib.import_module(
            f"edl_tpu_torch.distill.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

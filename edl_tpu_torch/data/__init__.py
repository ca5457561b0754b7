"""Data plane of the port: the tensor wire, the loaders and input planes,
the record server and the elastic task dispenser.

The package namespace resolves its public names lazily (PEP 562), as
``edl_tpu.data`` does: importing the package loads no submodule, so the
serving and dispensing planes start without the rest.
"""

_EXPORTS = {
    "DataServer": "edl_tpu_torch.data.data_server",
    "RemoteSource": "edl_tpu_torch.data.data_server",
    "ArraySource": "edl_tpu_torch.data.pipeline",
    "DataLoader": "edl_tpu_torch.data.pipeline",
    "FileSource": "edl_tpu_torch.data.pipeline",
    "TaskDataLoader": "edl_tpu_torch.data.task_loader",
    "npz_loader": "edl_tpu_torch.data.task_loader",
    "text_loader": "edl_tpu_torch.data.task_loader",
    "TaskMaster": "edl_tpu_torch.data.task_master",
    "file_list_specs": "edl_tpu_torch.data.task_master",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'edl_tpu_torch.data' has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))

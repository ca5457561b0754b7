"""Import-compat shim (port of ``edl_tpu.distill.tensor_wire``): the
binary tensor wire lives in the data layer (``data/tensor_wire.py``), so
that ``data`` never imports ``distill``. Import from
``edl_tpu_torch.data.tensor_wire`` in new code."""

from edl_tpu_torch.data.tensor_wire import *  # noqa: F401,F403
from edl_tpu_torch.data.tensor_wire import (MAGIC, MAX_HEADER,  # noqa: F401
                                            MAX_PAYLOAD, TensorWireError,
                                            recv_tensors, send_tensors)

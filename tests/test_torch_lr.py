"""The port's schedules (edl_tpu_torch/train/lr.py) against the JAX
package's optax schedules at every step 0..N.

Both evaluate in fp32 in optax's expression order; numpy's fp32 cos and
power may round differently from XLA's, so values agree to rtol 1e-6
(a few fp32 ulps), with atol 1e-12 for the steps where both are zero.
"""

import numpy as np
import pytest

from edl_tpu.train import lr as jlr
from edl_tpu_torch.train import lr as tlr

CASES = [
    ("cosine_with_warmup", (3e-4, 40, 4)),        # lm_train's shape
    ("cosine_with_warmup", (3e-4, 40, 4, 1e-5)),  # with an end lr
    ("cosine_with_warmup", (0.1, 30)),            # no warmup
    ("cosine_with_warmup", (0.1, 30, 0, 0.01)),
    ("cosine_with_warmup", (1e-3, 5, 10)),        # warmup past the total
    ("linear_warmup", (0.5, 8)),
    ("linear_warmup", (0.5, 0)),
    ("piecewise_with_warmup", ([10, 20], [0.1, 0.01, 0.001], 5)),
    ("piecewise_with_warmup", ([10, 20], [0.1, 0.01, 0.001], 0)),
    ("exponential_with_warmup", (0.1, 5, 10, 0.5)),
    ("exponential_with_warmup", (0.1, 0, 7, 0.9, False)),
]


@pytest.mark.parametrize("name,args", CASES,
                         ids=[f"{n}{a}" for n, a in CASES])
def test_schedule_matches_optax(name, args):
    want_fn = getattr(jlr, name)(*args)
    got_fn = getattr(tlr, name)(*args)
    steps = range(0, 45)
    want = np.asarray([float(want_fn(np.int32(s))) for s in steps])
    got = np.asarray([got_fn(s) for s in steps])
    assert all(isinstance(got_fn(s), float) for s in (0, 3))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_scale_for_world():
    assert tlr.scale_for_world(0.1, 4, 8) == jlr.scale_for_world(0.1, 4, 8)
    assert tlr.scale_for_world(0.1, 0, 2) == jlr.scale_for_world(0.1, 0, 2)

"""The port against ``tests/test_single_pass.py:17-58``: one axis alone.

The row pass and the column pass of ``lanczos_torch.ops.apply_banded``
(drop edges, unnormalized, the oracle's double coordinates), each against
the port's one-axis float64 oracle (``ref/oracle.oracle_resample_axis0``)
and the JAX ``apply_banded`` on the same image.  Tolerance 5e-4, as
there: the JAX pass runs in float32 (its x64 is off), the port's in the
float64 the input carries.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from lanczos_tpu.core.config import EdgeMode as JaxEdgeMode  # noqa: E402
from lanczos_tpu.core.weights import banded_weights as jax_banded_weights  # noqa: E402
from lanczos_tpu.ops.resample_xla import apply_banded as jax_apply_banded  # noqa: E402

from lanczos_torch.core.config import EdgeMode  # noqa: E402
from lanczos_torch.core.weights import banded_weights  # noqa: E402
from lanczos_torch.ops import apply_banded  # noqa: E402
from lanczos_torch.ref.oracle import oracle_resample_axis0  # noqa: E402


def _pass(img: np.ndarray, out_size: int, axis: int) -> tuple:
    """The port's and the JAX package's one-axis pass of ``img``."""
    kw = dict(normalize=False, coord_mode="c_double")
    op = banded_weights(img.shape[axis], out_size, 2, "lanczos", EdgeMode.DROP, **kw)
    mine = apply_banded(torch.from_numpy(img.astype(np.float64)), torch.from_numpy(op.idx),
                        torch.from_numpy(op.weights), axis=axis).numpy()
    jop = jax_banded_weights(img.shape[axis], out_size, 2, "lanczos", JaxEdgeMode.DROP, **kw)
    theirs = np.asarray(jax_apply_banded(jnp.asarray(img, jnp.float64), jnp.asarray(jop.idx),
                                         jnp.asarray(jop.weights), axis=axis))
    return mine, theirs


@pytest.mark.parametrize("scale", [(2, 1), (3, 1), (5, 2)])
def test_row_pass_alone_vs_row_oracle(scale):
    """The horizontal pass alone: the oracle along axis 0 of the transposed
    image."""
    n, d = scale
    w_in = 16 * d
    img = np.random.default_rng(42).integers(0, 256, size=(12, w_in, 3)).astype(np.uint8)
    out_w = w_in * n // d
    want = oracle_resample_axis0(
        np.ascontiguousarray(img.transpose(1, 0, 2)), out_w, 2
    ).transpose(1, 0, 2)
    mine, theirs = _pass(img, out_w, 1)
    np.testing.assert_allclose(mine, want, atol=5e-4)
    np.testing.assert_allclose(theirs, want, atol=5e-4)
    np.testing.assert_allclose(mine, theirs, atol=5e-4)


def test_col_pass_alone_vs_col_oracle():
    img = np.random.default_rng(42).integers(0, 256, size=(20, 8, 3)).astype(np.uint8)
    want = oracle_resample_axis0(img, 40, 2)
    mine, theirs = _pass(img, 40, 0)
    np.testing.assert_allclose(mine, want, atol=5e-4)
    np.testing.assert_allclose(theirs, want, atol=5e-4)
    np.testing.assert_allclose(mine, theirs, atol=5e-4)

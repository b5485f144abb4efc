"""Port parity of the deployable AMS-Quant linear layer
(`core.qlinear.QuantizedLinear`, `quantize_linear`, `dequantize_weight`,
`apply`) against the JAX package's `repro.core.qlinear` on the CPU, with the
same numpy-made weights and inputs: packed planes and dequantized weights
bit-equal; ``ref`` and ``fused_ref`` against the reference's, ``kernel``
(the plain versions of K1 / K1b on CPU tensors) against its Pallas kernel
in interpret mode, within 1e-6 of the largest output.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import qlinear as JQ  # noqa: E402
from repro.core.formats import get_scheme as j_get_scheme  # noqa: E402
from repro_torch.core import QuantizedLinear, apply, quantize_linear  # noqa: E402
from repro_torch.core import qlinear as TQ  # noqa: E402
from repro_torch.core.formats import get_scheme  # noqa: E402


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("scheme", ["fp5.33-e2m3", "fp4.25-e2m2", "fp6-e2m3"])
def test_quantized_linear_matches_reference(scheme, bias):
    """quantize_linear packs bit-equal planes; ``ref`` / ``fused_ref``
    against the reference's, ``kernel`` (K1 / K1b's plain versions on CPU
    tensors) against its ``pallas_interpret``: bit-equal."""
    rng = np.random.default_rng(4)
    K, N = 100, 48
    w = (rng.standard_normal((K, N)) / 10).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32) if bias else None
    x = rng.standard_normal((5, K)).astype(np.float32)
    jq = JQ.quantize_linear(jnp.asarray(w), j_get_scheme(scheme),
                            None if b is None else jnp.asarray(b))
    tq = TQ.quantize_linear(torch.from_numpy(w), get_scheme(scheme),
                            None if b is None else torch.from_numpy(b))
    assert (tq.in_features, tq.out_features) == (jq.in_features, jq.out_features) == (K, N)
    assert tq.scheme.name == jq.scheme.name
    for n in ("hi", "lsb", "scale"):
        np.testing.assert_array_equal(getattr(tq.packed, n).numpy(),
                                      np.asarray(getattr(jq.packed, n)))
    np.testing.assert_array_equal(TQ.dequantize_weight(tq, torch.float32).numpy(),
                                  np.asarray(JQ.dequantize_weight(jq, jnp.float32)))
    for timpl, jimpl in (("ref", "ref"), ("fused_ref", "fused_ref"),
                         ("kernel", "pallas_interpret")):
        got = TQ.apply(tq, torch.from_numpy(x), timpl).numpy()
        want = np.asarray(JQ.apply(jq, jnp.asarray(x), jimpl))
        assert got.shape == (5, N)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max(),
                                   err_msg=f"{timpl} vs {jimpl}")
    with pytest.raises(ValueError, match="unknown impl"):
        TQ.apply(tq, torch.from_numpy(x), "pallas")


def test_core_exports_the_quantized_linear():
    """`repro_torch.core` exports the layer as `repro.core` does."""
    assert QuantizedLinear is TQ.QuantizedLinear and apply is TQ.apply
    assert quantize_linear is TQ.quantize_linear

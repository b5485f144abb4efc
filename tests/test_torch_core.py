"""Port parity, core numerics: formats, RTN, AMS sharing, packing, AMS-KV.

The same numpy inputs go through the JAX package (on the CPU) and the
PyTorch port; every integer result and every decoded value must be
bit-equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: more intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ams as JA  # noqa: E402
from repro.core import formats as JF  # noqa: E402
from repro.core import kv_quant as JK  # noqa: E402
from repro.core import packing as JP  # noqa: E402
from repro.core import rtn as JR  # noqa: E402
from repro_torch.core import ams as TA  # noqa: E402
from repro_torch.core import formats as TF  # noqa: E402
from repro_torch.core import kv_quant as TK  # noqa: E402
from repro_torch.core import packing as TP  # noqa: E402
from repro_torch.core import rtn as TR  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402


def f32_bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def weights(K, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, N)) * 0.02).astype(np.float32)


@pytest.mark.parametrize("name", sorted(JF.FORMATS))
def test_code_to_value_every_code_bit_equal(name):
    fmt = JF.FORMATS[name]
    codes = np.arange(1 << fmt.total_bits, dtype=np.int32)
    want = JF.code_to_value(fmt, jnp.asarray(codes))
    got = TF.code_to_value(TF.FORMATS[name], torch.from_numpy(codes))
    np.testing.assert_array_equal(f32_bits(got.numpy()), f32_bits(want))


def test_scheme_registry_matches():
    assert {k: (v.base.name, v.k) for k, v in JF.SCHEMES.items()} == \
        {k: (v.base.name, v.k) for k, v in TF.SCHEMES.items()}


@pytest.mark.parametrize("fmt", ["e2m3", "e2m2"])
def test_rtn_codes_and_scales_bit_equal(fmt):
    w = weights(213, 160, 1)
    c1, s1 = JR.quantize_rtn(jnp.asarray(w), JF.get_format(fmt))
    c2, s2 = TR.quantize_rtn(torch.from_numpy(w), TF.get_format(fmt))
    np.testing.assert_array_equal(np.asarray(c1), c2.numpy())
    np.testing.assert_array_equal(f32_bits(s1), f32_bits(s2.numpy()))


# K not a multiple of 6 (213 = 3 * 71, 212 = 4 * 53): pack pads to the block
@pytest.mark.parametrize("scheme,K", [("fp5.33-e2m3", 213), ("fp4.25-e2m2", 212)])
@pytest.mark.parametrize("strategy", ["set_lsb", "requantize"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ams_codes_and_scales_bit_equal(scheme, K, strategy, seed):
    w = weights(K, 300, seed)
    c1, s1 = JA.ams_quantize(jnp.asarray(w), JF.get_scheme(scheme), strategy)
    c2, s2 = TA.ams_quantize(torch.from_numpy(w), TF.get_scheme(scheme), strategy)
    np.testing.assert_array_equal(np.asarray(c1), c2.numpy())
    np.testing.assert_array_equal(f32_bits(s1), f32_bits(s2.numpy()))


@pytest.mark.parametrize("scheme,container,K", [
    ("fp5.33-e2m3", "fp533", 213), ("fp5.33-e2m3", "planes", 213),
    ("fp4.25-e2m2", "planes", 212), ("fp6-e2m3", None, 50), ("fp8", None, 77)])
def test_packed_words_bit_equal(scheme, container, K):
    w = weights(K, 96, 3)
    js, ts = JF.get_scheme(scheme), TF.get_scheme(scheme)
    c1, s1 = JA.ams_quantize(jnp.asarray(w), js)
    c2, s2 = TA.ams_quantize(torch.from_numpy(w), ts)
    p1 = JP.pack(c1, s1, js, container)
    p2 = TP.pack(c2, s2, ts, container)
    assert (p2.layout.container, p2.layout.k_block) == (p1.layout.container, p1.layout.k_block)
    np.testing.assert_array_equal(np.asarray(p1.hi), p2.hi.numpy())
    np.testing.assert_array_equal(np.asarray(p1.lsb), p2.lsb.numpy())
    np.testing.assert_array_equal(TP.unpack(p2).numpy(), c2.numpy())
    assert p2.layout.padded_k(K) == p1.layout.padded_k(K)


def test_qwen2_7b_padded_k():
    lay = TP.make_layout(TF.get_scheme("fp5.33-e2m3"))
    assert lay.container == "fp533"
    assert (lay.padded_k(3584), lay.padded_k(18944)) == (3588, 18948)


@pytest.mark.parametrize("hd", [128, 32, 7, 10, 30])
@pytest.mark.parametrize("strategy", ["set_lsb", "requantize"])
def test_quantize_kv_planes_bit_equal(hd, strategy):
    """Against quantize_kv compiled, as the reference's engine step runs it
    (XLA turns the scale's division by max_normal into a reciprocal
    multiply there; the port's insert does the same)."""
    x = np.random.default_rng(hd).standard_normal((3, 5, 2, hd)).astype(np.float32)
    want = jax.jit(JK.quantize_kv, static_argnames="strategy")(jnp.asarray(x),
                                                                 strategy=strategy)
    got = TK.quantize_kv(torch.from_numpy(x), strategy=strategy)
    assert TK.packed_head_dim(hd) == JK.packed_head_dim(hd)
    for k in ("hi", "lsb", "scale"):
        a, b = np.asarray(want[k]), got[k].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=k)
    deq_j = JK.dequantize_kv(want, hd, dtype=jnp.float32)
    deq_t = TK.dequantize_kv(got, hd, dtype=torch.float32)
    np.testing.assert_array_equal(f32_bits(deq_j), f32_bits(deq_t.numpy()))
    codes_j = JK.codes_from_planes(want["hi"], want["lsb"], 4)
    codes_t = TK.codes_from_planes(got["hi"], got["lsb"], 4)
    np.testing.assert_array_equal(np.asarray(codes_j), codes_t.numpy())


def test_quantize_kv_empty_token_axis():
    got = TK.quantize_kv(torch.zeros((0, 2, 32)))
    assert got["hi"].shape == (0, 2, 16) and got["lsb"].shape == (0, 2, 1)


def test_params_from_numpy_keeps_bf16_bits():
    a = jnp.asarray(np.random.default_rng(0).standard_normal((4, 6)), jnp.bfloat16)
    t = params_from_numpy({"x": {"w": np.asarray(a)}})["x"]["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(a.astype(jnp.float32)))

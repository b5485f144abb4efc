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


# ------------------------------------------------------------------------
# XLA's CPU numerics the port copies on CPU tensors (`core.xla_math`)
# ------------------------------------------------------------------------
def _rows(n, width, seed):
    """n seeded rows of standard normals, each scaled by e^u, u in [-3, 3]."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, width)) * np.exp(rng.uniform(-3, 3, (n, 1)))).astype(np.float32)


@pytest.mark.parametrize("width", [128, 3584])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rms_norm_bit_equal_to_the_jitted_reference(width, dtype):
    """`models.common.rms_norm` on 20000 seeded rows against the reference's
    under jax.jit: the squares summed in XLA's reduce-window order, the mean
    and eps as one fused multiply-add, XLA's rsqrt (hardware estimate and
    two Newton steps)."""
    from repro.models.common import rms_norm as j_rms_norm
    from repro_torch.models.common import rms_norm

    x = _rows(20000, width, width)
    g = (1 + 0.1 * np.random.default_rng(1).standard_normal(width)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = jax.jit(lambda x, g: j_rms_norm(x.astype(jdt), g, 1e-6).astype(jnp.float32))(x, g)
    got = rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(g), 1e-6)
    assert np.array_equal(f32_bits(got.float().numpy()), f32_bits(want))


def test_xla_rsqrt_bit_equal_with_its_special_classes():
    """`xla_math.rsqrt_f32` against jitted ``lax.rsqrt`` over 2^16 values
    spread over every exponent, and zeros, infinities, denormals,
    negatives and NaN (where XLA keeps the raw estimate)."""
    from repro_torch.core.xla_math import rsqrt_f32

    rng = np.random.default_rng(0)
    bits = rng.integers(0, 0x7F800000, 1 << 16).astype(np.int32)
    x = np.concatenate([bits.view(np.float32),
                        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, -3e-39, 1e-40,
                                  1.0, 4.0], np.float32)])
    want = np.asarray(jax.jit(jax.lax.rsqrt)(x))
    got = rsqrt_f32(torch.from_numpy(x)).numpy()
    same = (f32_bits(got) == f32_bits(want)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), x[~same][:8]


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_bf16_dot_order_is_xla_s(hd):
    """q . k of bf16 operands (the plain attention's einsum) in XLA's CPU bf16
    dot order, against the jitted einsum with an f32 result."""
    from repro_torch.core.xla_math import pairs_bf16_dot
    from repro_torch.kernels.attention_template import _scores

    rng = np.random.default_rng(hd)
    q = rng.standard_normal((3, 4, 2, 2, hd)).astype(np.float32)
    k = rng.standard_normal((3, 32, 2, hd)).astype(np.float32)
    want = jax.jit(lambda q, k: jnp.einsum("bcngd,bknd->bcngk", q.astype(jnp.bfloat16),
                                           k.astype(jnp.bfloat16),
                                           preferred_element_type=jnp.float32))(q, k)
    tq, tk = torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16()
    if not pairs_bf16_dot(tq, tk):
        pytest.skip("this CPU has no AVX512-BF16: XLA's bf16 dot takes another path here")
    assert np.array_equal(f32_bits(_scores(tq, tk).numpy()), f32_bits(want))


@pytest.mark.parametrize("M,K,N", [(12, 128, 8192), (3, 256, 4096), (24, 512, 2048)])
def test_xla_cpu_projection_is_an_f32_dot_not_the_pair_order(M, K, N):
    """Why `apply_linear` keeps torch's bf16 product on CPU tensors: the
    reference's bf16 x bf16 -> bf16 projection compiles to a convert of
    both operands to f32 and an f32 dot (its HLO), whose summation order
    follows XLA's CPU GEMM blocking, not the `vdpbf16ps` pair order the
    attention's f32-result einsum takes (`xla_math.bf16_dot`). Neither
    torch's order nor the pair order gives XLA's bits at every shape; both
    stay within one bf16 rounding of them. Prints the mismatch counts."""
    from repro_torch.core.xla_math import bf16_dot, pairs_bf16_dot

    rng = np.random.default_rng(M + K)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((K, N)) / np.sqrt(K), jnp.bfloat16)
    f = jax.jit(lambda x, w: x @ w)
    hlo = f.lower(x, w).compile().as_text()
    assert "f32[%d,%d]{1,0} dot(" % (M, N) in hlo and "bf16[%d,%d]" % (M, N) in hlo
    want = np.asarray(f(x, w).astype(jnp.float32))
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    tw = torch.from_numpy(np.array(w.astype(jnp.float32))).bfloat16()
    got = (tx @ tw).float().numpy()
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    assert (np.abs(got - want) <= ulp).all()
    msg = f"torch order {int((got != want).sum())} of {got.size} outputs apart"
    if pairs_bf16_dot(tx, tw):
        pairs = bf16_dot(tx[:, None, :], tw.T[None, :, :]).bfloat16().float().numpy()
        assert (np.abs(pairs - want) <= ulp).all()
        msg += f", pair order {int((pairs != want).sum())}"
    print(f"[{M}, {K}] x [{K}, {N}]: {msg}")


def test_attention_scores_bit_equal_on_the_reduced_dbrx_chunk_step(monkeypatch):
    """The q . k of every layer of five ragged chunk-4 ticks of reduced
    dbrx-132b (3 layers, bf16 weights, contiguous cache, slot 2 idle) through
    the port's plain attention, against the reference's einsum under jit on
    the same operands."""
    from repro.configs import get_config
    from repro.models import init_params as j_init_params
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.core.xla_math import pairs_bf16_dot
    from repro_torch.kernels import attention_template as AT
    from repro_torch.launch.engine import prepare_params
    from repro_torch.models import decode_step, make_cache

    cfg = get_config("dbrx-132b").reduced(num_layers=3)
    tcfg = t_get_config("dbrx-132b").reduced(num_layers=3)
    params = prepare_params(params_from_numpy(jax.tree.map(
        np.asarray, j_init_params(jax.random.PRNGKey(0), cfg))), None)
    seen = []
    real = AT._scores
    monkeypatch.setattr(AT, "_scores", lambda qf, k: seen.append((qf, k)) or real(qf, k))
    B, C, cap = 3, 4, 32
    cache = make_cache(tcfg, B, cap)
    rng = np.random.default_rng(C)
    pos = np.array([0, 2, -1], np.int32)
    for _ in range(5):
        tok = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
        nv = np.array([C, C - 1, 0], np.int32)
        _, cache = decode_step(params, torch.from_numpy(tok), cache, torch.from_numpy(pos), tcfg,
                               nvalid=torch.from_numpy(nv))
        pos = pos + np.where(pos >= 0, nv, 0)
    assert len(seen) == 15
    if not pairs_bf16_dot(*seen[0]):
        pytest.skip("this CPU has no AVX512-BF16: XLA's bf16 dot takes another path here")
    einsum = jax.jit(lambda q, k: jnp.einsum("bcngd,bknd->bcngk", q, k,
                                             preferred_element_type=jnp.float32))
    for qf, k in seen:
        jq, jk = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (qf, k))
        assert np.array_equal(f32_bits(real(qf, k).numpy()), f32_bits(einsum(jq, jk)))

"""Port parity of the Mamba-1 block (`repro_torch.models.ssm`) against the
JAX package's `repro.models.ssm` on the CPU, on reduced falcon-mamba-7b
(d_model 128, d_inner 256, n 8, dt_rank 8, 2 layers) with the served
engine's bf16 cast of every stacked leaf.

The JAX side runs under `jax.jit`, as its engine runs it. Exact: the
depthwise conv and its state, XLA's CPU exp / log1p / softplus, the
read-out, and `mamba_decode`'s output and both states (the state update
is one fused multiply-add in the compiled step; an unfused f32 update is
shown to differ). Within stated tolerances: the chunked scan (another
association of the same products) and `mamba_train`; the prefill-then-
decode consistency of the port's own `forward_seq` and `decode_step`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.policy import QuantPolicy as JQuantPolicy  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.common import quantize_params as j_quantize_params  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.policy import QuantPolicy  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.launch.engine import prepare_params  # noqa: E402
from repro_torch.models import decode_step, forward_seq, make_cache  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "falcon-mamba-7b"
SCHEME = "fp5.33-e2m3"
SCAN_TOL = 1e-5     # chunked scan: max |d| / max |h|, f32 products in another association
TRAIN_TOL = 2e-2    # mamba_train y (bf16): max |d| / max |y|, a bf16 ulp of the largest


@pytest.fixture(scope="module")
def served():
    """Layer 0's mixer of reduced falcon-mamba-7b as the engines serve it
    (every stacked leaf of ndim >= 2 in bf16, so A_log, D and the biases
    too), unquantized and FP5.33-packed, on both sides:
    {scheme: (jax mixer, jax policy, torch mixer, torch policy)}."""
    cfg = get_config(ARCH).reduced()
    jp = j_init_params(jax.random.PRNGKey(0), cfg)
    npar = jax.tree.map(np.asarray, jp)
    jb = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, jp)
    out = {}
    for scheme in (None, SCHEME):
        jpol = tpol = None
        jq = jb
        if scheme:
            jpol = JQuantPolicy(scheme=scheme, impl="ref", min_elements=1 << 10)
            tpol = QuantPolicy(scheme=scheme, impl="ref", min_elements=1 << 10)
            jq = j_quantize_params(jb, jpol)
        tq = prepare_params(params_from_numpy(npar), tpol)
        out[scheme] = (jax.tree.map(lambda t: t[0], jq["layers"]["sub0"]["mixer"]), jpol,
                       tree_map(lambda t: t[0], tq["layers"]["sub0"]["mixer"]), tpol)
    return out


def bits(t):
    """Raw bits of a torch tensor or a JAX array, for exact comparison."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def states(B, seed=0):
    cfg = get_config(ARCH).reduced()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, cfg.ssm_conv - 1, cfg.d_inner)).astype(np.float32)
    ssm = rng.standard_normal((B, cfg.d_inner, cfg.ssm_state)).astype(np.float32)
    return x, conv, ssm


def to_t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------------ numerics
def test_xla_cpu_math_bit_equal():
    """exp, log1p and softplus of f32 over 6e5 values from denormals to the
    clamps equal XLA's compiled CPU results bit for bit (torch's own exp
    and log1p differ in a few per cent of elements)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(200000) * 8, rng.uniform(-100, 100, 100000),
                        rng.standard_normal(100000) * 1e-3, [0.0, -0.0, 1e-40, -1e-40,
                                                             88.0, -88.0, 200.0, -200.0]])
    x = x.astype(np.float32)
    e = np.concatenate([np.exp(-np.abs(x)), rng.uniform(-0.99, 20, 200000)]).astype(np.float32)
    for name, jf, tf, arg in (("exp", jnp.exp, TS.exp_f32, x),
                              ("log1p", jnp.log1p, TS.log1p_f32, e),
                              ("softplus", jax.nn.softplus, TS.softplus, x)):
        want = np.asarray(jax.jit(jf)(arg))
        got = tf(to_t(arg)).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=name)
    assert (torch.exp(to_t(x)).numpy() != np.asarray(jax.jit(jnp.exp)(x))).mean() > 0.01


@pytest.mark.parametrize("B,di,n", [(1, 256, 8), (1, 8192, 16), (4, 256, 8), (8, 8192, 16)])
def test_readout_bit_equal(B, di, n):
    """y = einsum("bdn,bn->bd", h, C) + D * xc as the compiled step sums it:
    a gemv in 8 lanes over several rows, a loop of fused multiply-adds for
    one row."""
    rng = np.random.default_rng(B + n)
    h, c = rng.standard_normal((B, di, n)), rng.standard_normal((B, n))
    d, xc = rng.standard_normal(di), rng.standard_normal((B, di))
    h, c, d, xc = (a.astype(np.float32) for a in (h, c, d, xc))
    want = jax.jit(lambda h, c, d, xc: jnp.einsum("bdn,bn->bd", h, c) + d[None] * xc)(
        h, c, d, xc)
    got = TS.readout(to_t(h), to_t(c)[:, None, :], to_t(d), to_t(xc))
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("S", [1, 5])
def test_causal_conv1d_bit_equal(S, served):
    """bf16 conv output and new state, with and without a carried state."""
    cfg = get_config(ARCH).reduced()
    jm, _, tm, _ = served[None]
    rng = np.random.default_rng(S)
    x = rng.standard_normal((3, S, cfg.d_inner)).astype(np.float32)
    st = rng.standard_normal((3, cfg.ssm_conv - 1, cfg.d_inner)).astype(np.float32)
    f = jax.jit(JS.causal_conv1d)
    for state in (None, st):
        js = None if state is None else jnp.asarray(state, jnp.bfloat16)
        ts = None if state is None else to_t(state, torch.bfloat16)
        jy, jn = f(jnp.asarray(x, jnp.bfloat16), jm["conv_w"], jm["conv_b"], js)
        ty, tn = TS.causal_conv1d(to_t(x, torch.bfloat16), tm["conv_w"], tm["conv_b"], ts)
        np.testing.assert_array_equal(bits(ty), bits(jy))
        np.testing.assert_array_equal(bits(tn), bits(jn))


# ---------------------------------------------------------------- decode
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("scheme", [None, SCHEME])
def test_mamba_decode_bit_equal(scheme, B, served):
    """y, the conv state and the ssm state bit-equal to the jitted
    reference (bf16 projections, or FP5.33 through the ref tier on both
    sides; one row takes the single-row read-out); the ssm state is the
    fused da * s + db: rounding the product first, as the eager op
    sequence does, differs."""
    cfg, tcfg = get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    jm, jpol, tm, tpol = served[scheme]
    x, conv, ssm = states(B)
    jy, (jc, jh) = jax.jit(lambda p, x, c, s: JS.mamba_decode(p, x, c, s, cfg, policy=jpol))(
        jm, jnp.asarray(x, jnp.bfloat16), jnp.asarray(conv, jnp.bfloat16), jnp.asarray(ssm))
    ty, (tc, th) = TS.mamba_decode(tm, to_t(x, torch.bfloat16), to_t(conv, torch.bfloat16),
                                   to_t(ssm), tcfg, policy=tpol)
    for got, want in ((ty, jy), (tc, jc), (th, jh)):
        np.testing.assert_array_equal(bits(got), bits(want))
    # the unfused f32 update, from the port's (bit-equal) scan elements
    xz = TS.apply_linear(tm["in_proj"], to_t(x, torch.bfloat16), tpol)
    xc, _ = TS.causal_conv1d(xz[..., :tcfg.d_inner], tm["conv_w"], tm["conv_b"],
                             to_t(conv, torch.bfloat16))
    da, db, _ = TS._mamba_core(tm, TS.silu(xc), tcfg, tpol)
    unfused = da[:, 0] * to_t(ssm) + db[:, 0]
    assert (unfused.numpy() != np.asarray(jh)).any()
    np.testing.assert_array_equal(bits(TS.fma_f32(da[:, 0], to_t(ssm), db[:, 0])), bits(jh))


def test_mamba_decode_live_mask(served):
    """Rows that are not live keep their conv and ssm bytes; live rows get
    the unmasked result."""
    tcfg = t_get_config(ARCH).reduced()
    _, _, tm, tpol = served[SCHEME]
    x, conv, ssm = states(3, seed=1)
    args = (tm, to_t(x, torch.bfloat16), to_t(conv, torch.bfloat16), to_t(ssm), tcfg)
    y0, (c0, h0) = TS.mamba_decode(*args, policy=tpol)
    live = torch.tensor([True, False, True])
    y1, (c1, h1) = TS.mamba_decode(*args, policy=tpol, live=live)
    assert torch.equal(y0.view(torch.int16), y1.view(torch.int16))
    for new, masked, old in ((c0, c1, args[2]), (h0, h1, args[3])):
        np.testing.assert_array_equal(bits(masked[1]), bits(old[1]))
        np.testing.assert_array_equal(bits(masked[[0, 2]]), bits(new[[0, 2]]))
        assert not torch.equal(new[1], old[1])


# ----------------------------------------------------------- sequences
@pytest.mark.parametrize("S,chunk", [(37, 8), (37, 256), (64, 16)])
def test_chunked_linear_scan_within_tolerance(S, chunk):
    """h_t = a_t h_{t-1} + b_t over [B, S, 16, 8] with a carried h0, against
    the jitted reference at chunk sizes that divide S, leave a ragged last
    chunk, or exceed it: every h_t within SCAN_TOL of max |h|."""
    rng = np.random.default_rng(S + chunk)
    a = rng.uniform(0.5, 1.0, (2, S, 16, 8)).astype(np.float32)
    b = rng.standard_normal((2, S, 16, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 16, 8)).astype(np.float32)
    jh, jN = jax.jit(lambda a, b, h: JS.chunked_linear_scan(a, b, h, chunk))(a, b, h0)
    th, tN = TS.chunked_linear_scan(to_t(a), to_t(b), to_t(h0), chunk)
    jh, jN = np.asarray(jh), np.asarray(jN)
    assert th.shape == jh.shape and tN.shape == jN.shape
    scale = np.abs(jh).max()
    assert np.abs(th.numpy() - jh).max() <= SCAN_TOL * scale
    np.testing.assert_array_equal(tN.numpy(), th.numpy()[:, -1])


@pytest.mark.parametrize("scheme", [None, SCHEME])
def test_mamba_train_within_tolerance(scheme, served):
    """The full-sequence mixer: y within TRAIN_TOL of max |y| (its scan and
    read-out associate differently), the final conv state bit-equal and the
    final ssm state within SCAN_TOL."""
    cfg, tcfg = get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    jm, jpol, tm, tpol = served[scheme]
    x = np.random.default_rng(2).standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    jy, (jc, jh) = jax.jit(lambda p, x: JS.mamba_train(p, x, cfg, policy=jpol, chunk=4))(
        jm, jnp.asarray(x, jnp.bfloat16))
    ty, (tc, th) = TS.mamba_train(tm, to_t(x, torch.bfloat16), tcfg, policy=tpol, chunk=4)
    jy = np.asarray(jy.astype(jnp.float32))
    assert np.abs(ty.float().numpy() - jy).max() <= TRAIN_TOL * np.abs(jy).max()
    np.testing.assert_array_equal(bits(tc), bits(jc))
    jh = np.asarray(jh)
    assert np.abs(th.numpy() - jh).max() <= SCAN_TOL * np.abs(jh).max()


def test_prefill_then_decode_matches_forward():
    """decode(t | cache(forward_seq(t_0..t_{n-1}))) == forward_seq(t_0..t_n)[-1]
    in f32 (the reference's test_prefill_decode_consistency, on the port):
    the prefill's final states continue the recurrence."""
    cfg = t_get_config(ARCH).reduced()
    npar = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(2), get_config(ARCH)
                                                  .reduced()))
    params = params_from_numpy(npar)
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12))
                           .astype(np.int32))
    full, _, _ = forward_seq(params, tok, cfg, dtype=torch.float32)
    _, _, cache = forward_seq(params, tok[:, :-1], cfg, dtype=torch.float32, want_cache=True)
    sub = cache["layers"]["sub0"]
    assert sub["conv"].shape == (cfg.num_layers, 2, cfg.ssm_conv - 1, cfg.d_inner)
    assert sub["ssm"].shape == (cfg.num_layers, 2, cfg.d_inner, cfg.ssm_state)
    big = make_cache(cfg, 2, 16, dtype=torch.float32)
    for k in ("conv", "ssm"):
        big["layers"]["sub0"][k].copy_(sub[k])
    dec, _ = decode_step(params, tok[:, -1], big, torch.full((2,), 11, dtype=torch.int32),
                         cfg, dtype=torch.float32)
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), rtol=2e-4, atol=2e-4)


def test_init_mamba_draws_and_dtypes():
    """init_mamba's tree and shapes are the reference's; the scan parameters
    are f32 (A_log = log 1..n per channel, D ones) until the engine's bf16
    cast; the draws come from the generator in order (in_proj first)."""
    cfg = t_get_config(ARCH).reduced()
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    p = TS.init_mamba(g1, cfg)
    want = jax.tree.map(lambda a: a.shape, JS.init_mamba(jax.random.PRNGKey(0),
                                                         get_config(ARCH).reduced()))
    assert tree_map(lambda t: tuple(t.shape), p) == want
    torch.testing.assert_close(p["in_proj"]["w"],
                               torch.randn((cfg.d_model, 2 * cfg.d_inner), generator=g2)
                               * (1.0 / np.sqrt(cfg.d_model)), rtol=0, atol=0)
    assert p["A_log"].dtype == p["D"].dtype == torch.float32
    torch.testing.assert_close(p["A_log"].exp()[0], torch.arange(1.0, cfg.ssm_state + 1))

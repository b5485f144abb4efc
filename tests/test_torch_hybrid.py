"""Port parity of the RG-LRU blocks, the (rec, rec, attn) pattern with its
tail and the sliding-window ring caches (reduced recurrentgemma-9b) against
the JAX package on the CPU, with numpy-made inputs and weights.

The JAX side runs under `jax.jit`, as its engine runs it. Exact: XLA's CPU
log / logistic / sqrt (`core.xla_math`); `rglru_decode`'s output and both
states on both tiers, for a stacked layer's bf16 Λ and the tail's f32 Λ;
the ring insert, `_to_ring`, and over several one-token steps at five
layers (one repeat and a two-block tail) every live slot's conv /
recurrent state and ring byte, with logits within 1e-5 of the largest (the
f32 head sums in another order). Within stated tolerances: the ring
flash-decode against the reference's (f32 sums in another order), and
`forward_seq` past the window (the chunked scan associates differently).
A sliding-window attn block on ``impl="kernel"`` never reaches K4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.policy import QuantPolicy as JQuantPolicy  # noqa: E402
from repro.kernels import attention_template as JAT  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward_seq as j_forward_seq  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_cache as j_make_cache  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import quantize_params as j_quantize_params  # noqa: E402
from repro_torch.cache import CacheConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import xla_math  # noqa: E402
from repro_torch.core.policy import QuantPolicy  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.kernels import attention_template as TAT  # noqa: E402
from repro_torch.launch.engine import init_serving_params, prepare_params  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import decode_step, forward_seq, init_params, make_cache  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "recurrentgemma-9b"
SCHEME = "fp5.33-e2m3"
TIERS = [("ref", "ref"), ("kernel", "pallas_interpret")]
LOGIT_ULP = 1e-5    # kernel-tier step logits: max |d| / max |logit|
ATTN_TOL = 1e-6     # ring flash-decode: max |d| / max |o| (f32 sums in another order)
SEQ_TOL = 2e-2      # forward_seq logits / states: a bf16 ulp of the largest


def bits(t):
    """Raw bits of a torch tensor or a JAX array, for exact comparison."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def to_t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def served(cfg, jimpl, impl, seed=0):
    """(jax params, jax policy, torch params, torch policy) as the engines
    serve them: every leaf of ndim >= 2 in bf16 (the stacked layers'
    norms, Λ and biases too; the tail keeps its 1-D leaves f32), FP5.33."""
    jp = j_init_params(jax.random.PRNGKey(seed), cfg)
    npar = jax.tree.map(np.asarray, jp)
    jb = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, jp)
    jpol = JQuantPolicy(scheme=SCHEME, impl=jimpl, min_elements=1 << 10)
    tpol = QuantPolicy(scheme=SCHEME, impl=impl, min_elements=1 << 10)
    return (j_quantize_params(jb, jpol), jpol,
            prepare_params(params_from_numpy(npar), tpol), tpol)


# ------------------------------------------------------------ numerics
def test_xla_log_sigmoid_sqrt_bit_equal():
    """log, sigmoid and sqrt of f32 over 6e5 values (denormals, zeros,
    infinities and negatives included) equal XLA's compiled CPU results bit
    for bit; torch's own sqrt and sigmoid differ on some of them."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(200000) * 8, rng.uniform(-100, 100, 100000),
                        [0.0, -0.0, 1e-40, -1e-40, 88.0, -88.0, 200.0, -200.0, np.inf]])
    x = x.astype(np.float32)
    pos = np.concatenate([np.abs(x), np.exp(rng.uniform(-87, 88, 300000)), [-1.0]])
    pos = pos.astype(np.float32)
    for name, jf, tf, arg in (("log", jnp.log, xla_math.log_f32, pos),
                              ("sigmoid", jax.nn.sigmoid, xla_math.sigmoid_f32, x),
                              ("sqrt", jnp.sqrt, xla_math.sqrt_f32, pos)):
        want = np.asarray(jax.jit(jf)(arg))
        got = tf(to_t(arg)).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=name)
    jsq = np.asarray(jax.jit(jnp.sqrt)(pos))
    assert (torch.sqrt(to_t(pos)).numpy().view(np.int32) != jsq.view(np.int32)).any()


@pytest.mark.parametrize("impl,jimpl", TIERS)
@pytest.mark.parametrize("where", ["stacked", "tail"])
def test_rglru_decode_bit_equal(impl, jimpl, where):
    """`rglru_decode` of a repeat's first rec block (bf16 Λ and conv bias,
    as the stacked tree casts them) and of the tail's (f32 Λ and bias), at
    a random Λ in [-1, 4) and a nonzero conv bias: y, the conv state and
    the recurrent state bit-equal to the jitted reference; rows not live
    keep their states."""
    cfg, tcfg = get_config(ARCH).reduced(num_layers=5), t_get_config(ARCH).reduced(num_layers=5)
    rng = np.random.default_rng(1)
    W = cfg.lru_width
    jp = j_init_params(jax.random.PRNGKey(0), cfg)
    for group in ("layers", "tail"):
        mix = jp[group]["sub0"]["mixer"]
        lead = mix["lam"].shape[:-1]
        mix["lam"] = jnp.asarray(rng.uniform(-1, 4, lead + (W,)), jnp.float32)
        mix["conv_b"] = jnp.asarray(rng.standard_normal(lead + (W,)) * 0.1, jnp.float32)
    npar = jax.tree.map(np.asarray, jp)
    jb = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, jp)
    jpol = JQuantPolicy(scheme=SCHEME, impl=jimpl, min_elements=1 << 10)
    tpol = QuantPolicy(scheme=SCHEME, impl=impl, min_elements=1 << 10)
    jq, tq = j_quantize_params(jb, jpol), prepare_params(params_from_numpy(npar), tpol)
    if where == "stacked":
        jm = jax.tree.map(lambda t: t[0], jq["layers"]["sub0"]["mixer"])
        tm = tree_map(lambda t: t[0], tq["layers"]["sub0"]["mixer"])
        assert tm["lam"].dtype == torch.bfloat16
    else:
        jm, tm = jq["tail"]["sub0"]["mixer"], tq["tail"]["sub0"]["mixer"]
        assert tm["lam"].dtype == torch.float32
    B = 4
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, 3, W)).astype(np.float32)
    st = rng.standard_normal((B, W)).astype(np.float32)
    jy, (jc, jh) = jax.jit(lambda p, x, c, s: JS.rglru_decode(p, x, c, s, cfg, policy=jpol))(
        jm, jnp.asarray(x, jnp.bfloat16), jnp.asarray(conv, jnp.bfloat16), jnp.asarray(st))
    args = (tm, to_t(x, torch.bfloat16), to_t(conv, torch.bfloat16), to_t(st), tcfg)
    ty, (tc, th) = TS.rglru_decode(*args, policy=tpol)
    for got, want in ((ty, jy), (tc, jc), (th, jh)):
        np.testing.assert_array_equal(bits(got), bits(want))
    live = torch.tensor([True, False, True, False])
    y1, (c1, h1) = TS.rglru_decode(*args, policy=tpol, live=live)
    assert torch.equal(y1, ty)
    assert torch.equal(c1[live], tc[live]) and torch.equal(c1[~live], args[2][~live])
    assert torch.equal(h1[live], th[live]) and torch.equal(h1[~live], args[3][~live])


# ------------------------------------------------------------ ring caches
def test_ring_insert_and_to_ring_bit_equal():
    """`cache_insert` with a ring window writes position p at slot p % W
    (a negative position writes nothing) and `_to_ring` lays the last W of
    a sequence out the same way, shorter than, equal to and longer than the
    window: bytes equal to the reference's."""
    rng = np.random.default_rng(2)
    W, B = 8, 4
    cache = rng.standard_normal((B, W, 1, 16)).astype(np.float32)
    new = rng.standard_normal((B, 1, 1, 16)).astype(np.float32)
    pos = np.array([3, 8, 21, -1], np.int32)
    want = jax.jit(lambda c, n, p: JA.cache_insert(c, n, p, ring_window=W))(cache, new, pos)
    got = TA.cache_insert(to_t(cache), to_t(new), to_t(pos), ring_window=W)
    np.testing.assert_array_equal(bits(got), bits(want))
    for S in (5, 8, 19):
        kv = rng.standard_normal((2, S, 1, 16)).astype(np.float32)
        np.testing.assert_array_equal(bits(TT._to_ring(to_t(kv), W)),
                                      bits(JT._to_ring(jnp.asarray(kv), W)))


@pytest.mark.parametrize("window,ring", [(8, True), (5, False)])
def test_ring_flash_decode_within_tolerance(window, ring):
    """`flash_decode` over a ring of width 8 (slots before, at and past a
    wrap, one idle) and over a plain cache with a window of 5: the visible
    keys are the reference's (`_cache_positions`: equal positions), and the
    outputs agree within ATTN_TOL of the largest."""
    rng = np.random.default_rng(3)
    B, S, H, kv, hd = 5, 8 if ring else 16, 4, 1, 16
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, kv, hd)).astype(np.float32)
    lens = np.array([0, 3, 8, 9, 27], np.int32) if ring else np.array([0, 3, 5, 9, 16], np.int32)
    kvm = np.zeros(H, np.int32)
    jpos = JAT._cache_positions(S, jnp.asarray(lens - 1)[:, None], 0, window if ring else 0)
    tpos = TAT._cache_positions(S, to_t(lens - 1)[:, None], window if ring else 0)
    np.testing.assert_array_equal(tpos.numpy(), np.broadcast_to(np.asarray(jpos), tpos.shape))
    want = np.asarray(jax.jit(lambda q, k, v, l: JAT.flash_decode(
        q, k, v, l, kv_map=kvm, window=window, ring=ring))(q, k, v, lens))
    got = TAT.flash_decode(to_t(q), to_t(k), to_t(v), to_t(lens), kv_map=kvm, window=window,
                           ring=ring).numpy()
    assert np.abs(got - want).max() <= ATTN_TOL * np.abs(want).max()
    assert not got[0].any()


def test_windowed_attention_never_reaches_k4(monkeypatch):
    """A sliding-window ring block on ``CacheConfig(impl="kernel")`` takes
    the plain flash-decode, as the reference routes ring caches: the K4
    wrapper, patched to raise, is never called by a recurrentgemma step;
    a dense model's step on the same setting does call it."""
    def k4(*a, **kw):
        raise AssertionError("K4 reached")

    monkeypatch.setattr(TAT, "contiguous_attention", k4)
    cfg = t_get_config(ARCH).reduced()
    params = init_params(0, cfg)
    cache = make_cache(cfg, 2, 16)
    ccfg = CacheConfig(impl="kernel")
    logits, _ = decode_step(params, torch.tensor([1, 2]), cache, torch.tensor([0, 70]), cfg,
                            cache_cfg=ccfg)
    assert torch.isfinite(logits).all()
    dense = t_get_config("qwen2-7b").reduced()
    with pytest.raises(AssertionError, match="K4 reached"):
        decode_step(init_params(0, dense), torch.tensor([1, 2]), make_cache(dense, 2, 16),
                    torch.tensor([0, 3]), dense, cache_cfg=ccfg)


# ------------------------------------------------------------ five layers
def test_decode_step_with_tail_bit_equal():
    """reduced(num_layers=5): one (rec, rec, attn) repeat and a (rec, rec)
    tail, kernel tier. Ten one-token steps of the jitted JAX decode step
    against the port's from positions 0 and 58 (the ring wraps) beside an
    idle slot: equal argmax, logits within LOGIT_ULP of max |logit|, and
    every live slot's conv / recurrent state (layers and tail) and ring
    byte equal after the last step."""
    cfg, tcfg = get_config(ARCH).reduced(num_layers=5), t_get_config(ARCH).reduced(num_layers=5)
    jp, jpol, tp, tpol = served(cfg, "pallas_interpret", "kernel")
    B, CAP = 3, 80
    step = jax.jit(lambda p, tok, c, pos: j_decode_step(p, tok, c, pos, cfg, policy=jpol))
    jc, tc = j_make_cache(cfg, B, CAP), make_cache(tcfg, B, CAP)
    rng = np.random.default_rng(4)
    pos = np.array([0, 58, -1], np.int32)
    ccfg = CacheConfig(impl="kernel")
    for _ in range(10):
        tok = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
        lj, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(pos))
        lt, tc = decode_step(tp, to_t(tok), tc, to_t(pos), tcfg, policy=tpol, cache_cfg=ccfg)
        lt, lj = lt.numpy()[:2], np.asarray(lj)[:2]
        assert np.abs(lt - lj).max() <= LOGIT_ULP * np.abs(lj).max()
        assert (lt.argmax(-1) == lj.argmax(-1)).all()
        pos = pos + np.where(pos >= 0, 1, 0)
    assert set(tc) == {"layers", "tail"} and set(tc["tail"]) == {"sub0", "sub1"}
    for group in ("layers", "tail"):
        for sub in tc[group]:
            for name, t in tc[group][sub].items():
                a = jc[group][sub][name]
                live = (slice(None), slice(0, 2)) if group == "layers" else (slice(0, 2),)
                np.testing.assert_array_equal(bits(t[live]), bits(a[live]),
                                              err_msg=f"{group}/{sub}/{name}")


def test_forward_seq_past_the_window_within_tolerance():
    """`forward_seq` of 80 tokens (past the 64-slot window, so `_to_ring`
    keeps the last 64) at five layers against the jitted reference's
    (kernel tier): logits within SEQ_TOL of the largest, equal argmax at
    99 % of positions or more, the ring caches and final recurrent states
    within SEQ_TOL of their largest; the cache tree is `make_cache`'s."""
    cfg, tcfg = get_config(ARCH).reduced(num_layers=5), t_get_config(ARCH).reduced(num_layers=5)
    jp, jpol, tp, tpol = served(cfg, "pallas_interpret", "kernel")
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 80)).astype(np.int32)
    jl, _, jc = jax.jit(lambda p, t: j_forward_seq(p, t, cfg, policy=jpol, want_cache=True))(
        jp, jnp.asarray(tok))
    tl, _, tc = forward_seq(tp, to_t(tok), tcfg, policy=tpol, want_cache=True)
    jl, tl = np.asarray(jl), tl.numpy()
    assert np.abs(tl - jl).max() <= SEQ_TOL * np.abs(jl).max()
    assert (tl.argmax(-1) == jl.argmax(-1)).mean() >= 0.99
    shapes = tree_map(lambda t: tuple(t.shape), make_cache(tcfg, 2, 80))
    assert tree_map(lambda t: tuple(t.shape), tc) == shapes
    assert tc["layers"]["sub2"]["k"].shape[2] == cfg.sliding_window
    for group in ("layers", "tail"):
        for sub in tc[group]:
            for name, t in tc[group][sub].items():
                a = np.asarray(jc[group][sub][name], np.float32)
                b = t.float().numpy()
                assert np.abs(a - b).max() <= SEQ_TOL * np.abs(a).max(), (group, sub, name)


def test_init_serving_params_matches_init_then_prepare():
    """The engine's layer-by-layer init gives the tree and the bytes of
    ``prepare_params(init_params(seed, cfg), quant)`` at five layers: the
    stacked repeats, the tail (1-D leaves f32) and lm_head, in the JAX
    tree's layout."""
    cfg = t_get_config(ARCH).reduced(num_layers=5)
    pol = QuantPolicy(scheme=SCHEME, impl="kernel", min_elements=1 << 10)
    got = init_serving_params(cfg, pol, 3, torch.device("cpu"))
    want = prepare_params(init_params(3, cfg), pol)
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), got) == \
        tree_map(lambda t: (tuple(t.shape), t.dtype), want)
    for a, b in zip(jax.tree.leaves(tree_map(bits, got)), jax.tree.leaves(tree_map(bits, want))):
        np.testing.assert_array_equal(a, b)
    jtree = j_init_params(jax.random.PRNGKey(0), get_config(ARCH).reduced(num_layers=5))
    assert jax.tree.structure(jax.tree.map(lambda x: 0, jtree)) == \
        jax.tree.structure(tree_map(lambda t: 0, init_params(0, cfg)))

"""Port parity of RecurrentGemma serving (reduced recurrentgemma-9b: one
(rec, rec, attn) repeat, lru_width 128, a 64-slot ring for the attn
block; FP5.33 weights, contiguous caches, the one-token step) against the
JAX package's engine and decode step on the CPU, with the same numpy-made
weights.

Exact: greedy streams and tick accounting on both tiers (the port's
``ref`` against the JAX ``ref`` engine, its ``kernel`` tier, the kernels'
plain versions here, against ``pallas_interpret``), three requests on two
slots so that a slot is reused, one of them a 74-token prompt that wraps
the ring; on the kernel tier a seeded sampled request among them; over
several one-token steps of the jitted JAX decode step, the live slots'
conv / recurrent states and ring bytes on both tiers (measured bit-equal;
the ref tier's bf16 x bf16 products could round one ulp apart, as on the
FP16 path, and are held to 2^-7 of the largest), with logits within 1e-5
of the largest on the kernel tier (the f32 head sums in another order)
and 2^-7 on the ref tier. An idle slot's states stay as they were in the
port (the reference advances them, and zeroes them at admission). Paged
caches and a ragged step (prefill_chunk > 1, speculation) are refused
before any weight is made, as the reference refuses them; a MoE model
over AMS pages with a ragged step passes those checks, as in the
reference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.policy import QuantPolicy as JQuantPolicy  # noqa: E402
from repro.launch.config import EngineConfig as JEngineConfig  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.launch.sampling import SamplingParams as JSamplingParams  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_cache as j_make_cache  # noqa: E402
from repro.models.common import quantize_params as j_quantize_params  # noqa: E402
from repro_torch.cache import CacheConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.policy import QuantPolicy  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import engine as engine_mod  # noqa: E402
from repro_torch.launch.config import EngineConfig  # noqa: E402
from repro_torch.launch.engine import ServeEngine, prepare_params  # noqa: E402
from repro_torch.launch.sampling import SamplingParams  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.steps import recurrent_states_kept  # noqa: E402
from repro_torch.models import decode_step, make_cache  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "recurrentgemma-9b"
SCHEME = "fp5.33-e2m3"
SLOTS, CAP = 2, 96
# (port impl, JAX impl): the plain tier, and the kernel tier (plain versions
# of the kernels here) against the JAX kernels' interpret lowering
TIERS = [("ref", "ref"), ("kernel", "pallas_interpret")]
LOGIT_ULP = 1e-5    # kernel-tier step logits: max |d| / max |logit|


@pytest.fixture(scope="module")
def weights():
    jp = j_init_params(jax.random.PRNGKey(0), get_config(ARCH).reduced())
    return jp, jax.tree.map(np.asarray, jp)


def workload():
    """Prompts of 9, 74 and 12 tokens: the second wraps the 64-slot ring."""
    rng = np.random.default_rng(3)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (9, 74, 12)]


def port_engine(npar, impl, **kw):
    return ServeEngine(EngineConfig(arch=ARCH, reduced=True, scheme=SCHEME, impl=impl,
                                    slots=SLOTS, capacity=CAP, device="cpu", **kw),
                       params=params_from_numpy(npar))


def cache_bytes(eng):
    return [t.view(torch.uint8).clone() for t in tree_leaves(eng.cache)]


@pytest.mark.parametrize("impl,jimpl", TIERS)
def test_streams_match_reference(impl, jimpl, weights):
    """Three requests on two slots (the third reuses a slot, whose states
    and ring rows admission zeroes), the 74-token prompt past the window:
    equal streams and tick accounting, and the reference's cost keys: its
    KV bytes per token (bf16 K and V of one kv head for every layer, rec
    layers included), floors and achieved bytes. On the kernel tier the first request is seeded and sampled:
    the same draws, so the same stream."""
    jp, npar = weights
    jeng = JServeEngine(JEngineConfig(arch=ARCH, reduced=True, scheme=SCHEME, impl=jimpl,
                                      slots=SLOTS, capacity=CAP), params=jp)
    eng = port_engine(npar, impl)
    out = []
    for e, sp in ((jeng, JSamplingParams), (eng, SamplingParams)):
        samp = [None] * 3
        if impl == "kernel":
            samp[0] = sp(temperature=0.8, top_k=40, top_p=0.9, seed=11)
        hs = [e.submit(p, 8, sampling=s) for p, s in zip(workload(), samp)]
        e.run()
        out.append(([list(h.tokens) for h in hs], e.stats()))
    (want, jst), (got, st) = out
    assert got == want
    for key in ("ticks", "tokens_generated", "ttft_ticks_p50", "latency_ticks_p50",
                "kv_bytes_per_token", "kv_compression_vs_bf16", "kv_bytes_per_token_floor",
                "kv_achieved_vs_floor", "floor_hbm_bytes", "floor_flops"):
        assert st[key] == jst[key], key
    cfg = get_config(ARCH).reduced()
    assert st["kv_bytes_per_token"] == cfg.num_layers * 2 * cfg.head_dim * 2


def bits(t):
    a = t.contiguous()
    return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a.view(torch.int32)).numpy()


def jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a.view(np.int32)


@pytest.mark.parametrize("impl,jimpl", TIERS)
def test_step_logits_states_and_ring_match_reference(impl, jimpl, weights):
    """Eight one-token steps of the jitted JAX decode step against the
    port's: slot 0 from position 0, slot 1 from position 60 (its ring wraps
    at the fifth step), slot 2 idle. Equal argmax throughout; the live
    slots' conv / recurrent states and the ring's K / V bytes after the
    last step bit-equal on the kernel tier, within 2^-7 of their largest
    on the ref tier (measured bit-equal there too); logits within LOGIT_ULP
    of max |logit| on the kernel tier (measured 0), one bf16 ulp of the
    largest on the ref tier. The idle slot's states stay zero in the port,
    while the reference advances them; neither writes its ring rows."""
    cfg, tcfg = get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    jp, npar = weights
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, jp)
    jpol = JQuantPolicy(scheme=SCHEME, impl=jimpl, min_elements=1 << 10)
    tpol = QuantPolicy(scheme=SCHEME, impl=impl, min_elements=1 << 10)
    jp = j_quantize_params(jp, jpol)
    tp = prepare_params(params_from_numpy(npar), tpol)
    B = 3
    step = jax.jit(lambda p, tok, c, pos: j_decode_step(p, tok, c, pos, cfg, policy=jpol))
    jc = j_make_cache(cfg, B, CAP)
    tc = make_cache(tcfg, B, CAP)
    rng = np.random.default_rng(0)
    pos = np.array([0, 60, -1], np.int32)
    exact = impl == "kernel"
    for _ in range(8):
        tok = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
        lj, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(pos))
        lt, tc = decode_step(tp, torch.from_numpy(tok), tc, torch.from_numpy(pos), tcfg,
                             policy=tpol, cache_cfg=CacheConfig(impl="kernel") if exact else None)
        lt, lj = lt.numpy()[:2], np.asarray(lj)[:2]
        assert np.abs(lt - lj).max() <= (LOGIT_ULP if exact else 2 ** -7) * np.abs(lj).max()
        assert (lt.argmax(-1) == lj.argmax(-1)).all()
        pos = pos + np.where(pos >= 0, 1, 0)
    assert pos[1] > cfg.sliding_window
    for sub, names in (("sub0", ("conv", "state")), ("sub1", ("conv", "state")),
                       ("sub2", ("k", "v"))):
        for name in names:
            a, b = jc["layers"][sub][name], tc["layers"][sub][name]
            if exact:
                np.testing.assert_array_equal(bits(b[:, :2]), jbits(a[:, :2]),
                                              err_msg=f"{sub}/{name}")
            else:
                a2, b2 = np.asarray(a[:, :2], np.float32), b[:, :2].float().numpy()
                assert np.abs(a2 - b2).max() <= 2 ** -7 * np.abs(a2).max()
            if name in ("conv", "state"):
                assert not b[:, 2].any() and np.asarray(a[:, 2], np.float32).any()
            else:
                assert not b[:, 2].any() and not np.asarray(a[:, 2], np.float32).any()


def test_idle_step_and_kept_states_leave_every_byte(weights):
    """The graph capture's warm-up: a step with every slot idle, between
    ticks of live requests (the long prompt's ring wrapped), changes no
    state or ring byte; a replay of the last tick's staged inputs inside
    `recurrent_states_kept` (which advances the states, and writes the
    ring slot from them) leaves every byte as it was. The streams go on as
    without either."""
    _, npar = weights
    eng, plain = port_engine(npar, "kernel"), port_engine(npar, "kernel")
    hs = [eng.submit(p, 6) for p in workload()]
    want = [plain.submit(p, 6) for p in workload()]
    plain.run()
    for _ in range(70):
        eng.step()
    before = cache_bytes(eng)
    assert all(b.any() for b in before)
    eng.inputs.set_idle()
    eng.device_step(1)
    assert all(torch.equal(a, b) for a, b in zip(before, cache_bytes(eng)))
    eng.step()
    before = cache_bytes(eng)
    with recurrent_states_kept(eng.cache, eng.cfg):
        eng.device_step(1)            # a replay of the last tick's staged inputs
        assert not all(torch.equal(a, b) for a, b in zip(before, cache_bytes(eng)))
    assert all(torch.equal(a, b) for a, b in zip(before, cache_bytes(eng)))


@pytest.mark.parametrize("case", ["paged", "chunk4", "speculate2", "dbrx"])
def test_refusals_before_any_weight(case, monkeypatch):
    """Paged caches and a ragged step (prefill_chunk 4, or speculation,
    whose step is ragged) on recurrentgemma-9b raise NotImplementedError
    before a weight is made, as the reference refuses them; a MoE model
    (dbrx-132b), whose layers the port serves on every cache and step, over
    AMS pages with a chunk of 4 passes every check and reaches its
    weights."""
    def no_weights(*a, **kw):
        raise AssertionError("weights were made before the refusal")

    monkeypatch.setattr(engine_mod, "init_serving_params", no_weights)
    monkeypatch.setattr(engine_mod, "prepare_params", no_weights)
    kw = {"paged": dict(cache=CacheConfig(kind="paged_ams")),
          "chunk4": dict(prefill_chunk=4),
          "speculate2": dict(speculate_k=2),
          "dbrx": dict(arch="dbrx-132b", cache=CacheConfig(kind="paged_ams"),
                       prefill_chunk=4)}[case]
    cfg = dict(arch=ARCH, reduced=True, scheme=SCHEME, slots=SLOTS, capacity=CAP)
    cfg.update(kw)
    if case == "dbrx":
        with pytest.raises(AssertionError, match="weights were made"):
            ServeEngine(EngineConfig(device="cpu", **cfg))
        return
    with pytest.raises(NotImplementedError, match="paged|chunked"):
        ServeEngine(EngineConfig(device="cpu", **cfg))
    if case == "paged":
        from repro.cache import CacheConfig as JCacheConfig
        cfg["cache"] = JCacheConfig(kind="paged_ams")
    with pytest.raises(NotImplementedError):
        JServeEngine(JEngineConfig(**cfg))


def test_generate_serves_recurrentgemma():
    """`serve.generate` serves reduced recurrentgemma-9b on the one-token
    step, prompts past the ring's window."""
    tokens, stats = generate(ARCH, prefill_chunk=1, batch=2, prompt_len=70, gen_tokens=4,
                             impl="kernel", attn_impl="kernel", device="cpu")
    assert tokens.shape == (2, 4) and (tokens >= 0).all()
    assert stats["tokens_generated"] == 8

"""Port parity of Mamba serving (reduced falcon-mamba-7b, FP5.33 weights,
contiguous conv / ssm state caches, the one-token step) against the JAX
package's engine and decode step on the CPU, with the same numpy-made
weights.

Exact: greedy streams and tick accounting on both tiers (the port's
``ref`` against the JAX ``ref`` engine, its ``kernel`` tier, the kernels'
plain versions here, against ``pallas_interpret``), three requests on two
slots so that a slot is reused; one seeded sampled stream; the live
slots' states of the jitted JAX decode step on the kernel tier, whose
per-step logits agree to 1e-5 of the largest (the ref tier's bf16 x bf16
projections round a few outputs one ulp apart, as on the FP16 path). An
idle slot's states stay as they were in the port (the reference advances
them, and zeroes them at admission). A ragged step, speculation and paged
caches are refused before any weight is made, as the reference refuses
them (and so are RecurrentGemma-9B's paged cache and ragged step, and a
MoE model). The ``fused_ref`` tier (out_proj's input unrounded, as the
compiled reference keeps it) gives the JAX ``fused_ref`` engine's streams
and tick accounting, and its step's states bit for bit, with logits
within 1e-5 of the largest (measured equal).
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
from repro_torch.models import decode_step, make_cache  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.common import apply_linear  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "falcon-mamba-7b"
SCHEME = "fp5.33-e2m3"
SLOTS, CAP = 2, 32
# (port impl, JAX impl): the plain tier, and the kernel tier (plain versions
# of the kernels here) against the JAX kernels' interpret lowering
TIERS = [("ref", "ref"), ("kernel", "pallas_interpret")]
LOGIT_ULP = 1e-5    # kernel-tier step logits: max |d| / max |logit|


@pytest.fixture(scope="module")
def weights():
    jp = j_init_params(jax.random.PRNGKey(0), get_config(ARCH).reduced())
    return jp, jax.tree.map(np.asarray, jp)


def workload():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (9, 5, 12)]


def engines(weights, impl, jimpl, **kw):
    jp, npar = weights
    jeng = JServeEngine(JEngineConfig(arch=ARCH, reduced=True, scheme=SCHEME, impl=jimpl,
                                      slots=SLOTS, capacity=CAP, **kw), params=jp)
    eng = ServeEngine(EngineConfig(arch=ARCH, reduced=True, scheme=SCHEME, impl=impl,
                                   slots=SLOTS, capacity=CAP, device="cpu", **kw),
                      params=params_from_numpy(npar))
    return jeng, eng


def cache_bytes(eng):
    return [t.view(torch.uint8).clone() for t in tree_leaves(eng.cache)]


@pytest.mark.parametrize("impl,jimpl", TIERS)
def test_streams_match_reference(impl, jimpl, weights):
    """Three greedy requests on two slots (the third reuses a slot, whose
    states admission zeroes): equal streams and tick accounting; the
    phantom KV bytes per token of the reference's formula (bf16 K and V of
    num_kv_heads 1 x head_dim per layer, though Mamba keeps no KV) are the
    reference's."""
    jeng, eng = engines(weights, impl, jimpl)
    out = []
    for e in (jeng, eng):
        hs = [e.submit(p, 8) for p in workload()]
        e.run()
        out.append(([list(h.tokens) for h in hs], e.stats()))
    (want, jst), (got, st) = out
    assert got == want
    for key in ("ticks", "tokens_generated", "ttft_ticks_p50", "latency_ticks_p50",
                "kv_bytes_per_token", "kv_compression_vs_bf16"):
        assert st[key] == jst[key], key
    cfg = get_config(ARCH).reduced()
    assert st["kv_bytes_per_token"] == cfg.num_layers * 2 * cfg.head_dim * 2


def test_sampled_stream_matches_reference(weights):
    """One seeded sampled request beside a greedy one (kernel tier against
    pallas_interpret): the same draws, so the same stream."""
    jeng, eng = engines(weights, "kernel", "pallas_interpret")
    prompts = workload()[:2]
    out = []
    for e, sp in ((jeng, JSamplingParams), (eng, SamplingParams)):
        samp = [sp(temperature=0.8, top_k=40, top_p=0.9, seed=11), None]
        hs = [e.submit(p, 10, sampling=s) for p, s in zip(prompts, samp)]
        e.run()
        out.append([list(h.tokens) for h in hs])
    assert out[1] == out[0]


@pytest.mark.parametrize("impl,jimpl", TIERS)
def test_step_logits_and_states_match_reference(impl, jimpl, weights):
    """Six one-token steps of the jitted JAX decode step against the port's
    (two live slots from different positions, one idle), equal argmax
    throughout. Kernel tier: the live slots' conv / ssm states bit-equal,
    logits within LOGIT_ULP of max |logit| (the f32 head sums in another
    order: measured 2.6e-7). Ref tier: its projections are bf16 x bf16
    products, which torch and XLA sum in other orders, so a few bf16
    outputs round one ulp apart and the flips carry on (as on the FP16
    path, test_torch_engine.py): logits within one bf16 ulp of the largest
    (measured 3.7e-3 of max |logit|), states within 2^-7 of their largest
    (measured 3.1e-4). The idle slot's states stay zero in the port, while
    the reference advances them."""
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
    pos = np.array([0, 2, -1], np.int32)
    exact = impl == "kernel"
    for _ in range(6):
        tok = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
        lj, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(pos))
        lt, tc = decode_step(tp, torch.from_numpy(tok), tc, torch.from_numpy(pos), tcfg,
                             policy=tpol)
        lt, lj = lt.numpy()[:2], np.asarray(lj)[:2]
        assert np.abs(lt - lj).max() <= (LOGIT_ULP if exact else 2 ** -7) * np.abs(lj).max()
        assert (lt.argmax(-1) == lj.argmax(-1)).all()
        pos = pos + np.where(pos >= 0, 1, 0)
    for name in ("conv", "ssm"):
        a, b = np.asarray(jc["layers"]["sub0"][name]), tc["layers"]["sub0"][name]
        if exact:
            np.testing.assert_array_equal(b[:, :2].contiguous().view(torch.uint8).numpy(),
                                          a[:, :2].view(np.uint8))
        else:
            a2, b2 = np.asarray(a[:, :2], np.float32), b[:, :2].float().numpy()
            assert np.abs(a2 - b2).max() <= 2 ** -7 * np.abs(a2).max()
        assert not b[:, 2].any() and np.asarray(a[:, 2], np.float32).any()


def test_fused_ref_tier_matches_reference(weights, monkeypatch):
    """impl="fused_ref" on both sides: the workload's greedy streams and
    tick accounting equal the JAX fused_ref engine's; six one-token steps of
    the jitted JAX decode step give the live slots' conv / ssm states bit
    for bit and logits within LOGIT_ULP of max |logit|. Rounding out_proj's
    input ``bf16(y) * silu(z)`` to bf16 (what the port did before) moves
    the logits by more than 1e-3 of the largest and the states."""
    jeng, eng = engines(weights, "fused_ref", "fused_ref")
    out = []
    for e in (jeng, eng):
        hs = [e.submit(p, 8) for p in workload()]
        e.run()
        out.append(([list(h.tokens) for h in hs], e.stats()))
    (want, jst), (got, st) = out
    assert got == want
    for key in ("ticks", "tokens_generated", "ttft_ticks_p50", "latency_ticks_p50"):
        assert st[key] == jst[key], key

    cfg, tcfg = get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    jp, npar = weights
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, jp)
    jpol = JQuantPolicy(scheme=SCHEME, impl="fused_ref", min_elements=1 << 10)
    tpol = QuantPolicy(scheme=SCHEME, impl="fused_ref", min_elements=1 << 10)
    jp = j_quantize_params(jp, jpol)
    tp = prepare_params(params_from_numpy(npar), tpol)
    step = jax.jit(lambda p, tok, c, pos: j_decode_step(p, tok, c, pos, cfg, policy=jpol))

    def run(rounded):
        if rounded:
            monkeypatch.setattr(TS, "_gated_out", lambda p, y, z, policy: apply_linear(
                p, y.to(z.dtype) * TS.silu(z), policy))
        B = 3
        jc, tc = j_make_cache(cfg, B, CAP), make_cache(tcfg, B, CAP)
        rng = np.random.default_rng(0)
        pos = np.array([0, 2, -1], np.int32)
        worst = 0.0
        for _ in range(6):
            tok = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
            lj, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(pos))
            lt, tc = decode_step(tp, torch.from_numpy(tok), tc, torch.from_numpy(pos), tcfg,
                                 policy=tpol)
            lt, lj = lt.numpy()[:2], np.asarray(lj)[:2]
            worst = max(worst, float(np.abs(lt - lj).max() / np.abs(lj).max()))
            pos = pos + np.where(pos >= 0, 1, 0)
        same = all(np.array_equal(tc["layers"]["sub0"][n][:, :2].contiguous().view(torch.uint8)
                                  .numpy(), np.asarray(jc["layers"]["sub0"][n][:, :2])
                                  .view(np.uint8)) for n in ("conv", "ssm"))
        return worst, same

    worst, same = run(rounded=False)
    assert worst <= LOGIT_ULP and same
    worst, same = run(rounded=True)
    assert worst > 1e-3 and not same


def test_idle_step_leaves_every_state_byte(weights):
    """The graph capture's warm-up: a step with every slot idle, between
    ticks of live requests, changes no state byte; the streams go on as
    without it."""
    _, npar = weights

    def port():
        return ServeEngine(EngineConfig(arch=ARCH, reduced=True, scheme=SCHEME, impl="kernel",
                                        slots=SLOTS, capacity=CAP, device="cpu"),
                           params=params_from_numpy(npar))

    eng, plain = port(), port()
    hs = [eng.submit(p, 6) for p in workload()]
    want = [plain.submit(p, 6) for p in workload()]
    plain.run()
    for _ in range(7):
        eng.step()
    before = cache_bytes(eng)
    assert all(b.any() for b in before)
    eng.inputs.set_idle()
    eng.device_step(1)
    assert all(torch.equal(a, b) for a, b in zip(before, cache_bytes(eng)))
    eng.run()
    assert [h.tokens for h in hs] == [h.tokens for h in want]


@pytest.mark.parametrize("case", ["paged", "chunk4", "speculate2", "recurrentgemma", "moe"])
def test_refusals_before_any_weight(case, monkeypatch):
    """Paged caches, a ragged step (prefill_chunk 4, or speculation, whose
    step is ragged) on falcon-mamba-7b raise NotImplementedError before a
    weight is made, and so do RecurrentGemma-9B's paged cache and ragged
    step; the reference refuses the same configurations. A MoE model
    (dbrx-132b), whose layers the port serves, passes the checks with a
    chunk of 4 and reaches its weights, as in the reference."""
    def no_weights(*a, **kw):
        raise AssertionError("weights were made before the refusal")

    monkeypatch.setattr(engine_mod, "init_serving_params", no_weights)
    monkeypatch.setattr(engine_mod, "prepare_params", no_weights)
    cfg = dict(arch=ARCH, reduced=True, scheme=SCHEME, slots=SLOTS, capacity=CAP)
    if case == "recurrentgemma":   # the reference's refusals: test_torch_serve_hybrid.py
        rg = dict(cfg, arch="recurrentgemma-9b")
        for kw in (dict(cache=CacheConfig(kind="paged_ams")), dict(prefill_chunk=4)):
            with pytest.raises(NotImplementedError, match="paged|chunked"):
                ServeEngine(EngineConfig(device="cpu", **rg, **kw))
        return
    kw = {"paged": dict(cache=CacheConfig(kind="paged_ams")),
          "chunk4": dict(prefill_chunk=4),
          "speculate2": dict(speculate_k=2),
          "moe": dict(arch="dbrx-132b", prefill_chunk=4)}[case]
    cfg.update(kw)
    if case == "moe":
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


def test_generate_serves_falcon_mamba():
    """`serve.generate` serves reduced falcon-mamba-7b on the one-token step."""
    tokens, stats = generate(ARCH, prefill_chunk=1, batch=2, prompt_len=6, gen_tokens=4,
                             impl="kernel", device="cpu")
    assert tokens.shape == (2, 4) and (tokens >= 0).all()
    assert stats["tokens_generated"] == 8

"""Port parity of the rest of the dense model zoo, served: GELU MLPs
(musicgen-medium) and modality prefix embeddings fed through the engine
step (internvl2-1b), against the JAX package on the CPU with the same
numpy-made weights and inputs. The JAX side runs as its engine and tests
run it: the FFN and the engine step compiled by XLA. Exact: FFN bits,
greedy streams, tick accounting, a preempted prefix-embed request's
stream. `test_torch_zoo_seq.py` holds the per-step logits, the sequence
forward, the self drafters and `QuantizedLinear`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cache import CacheConfig as JCacheConfig  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.policy import QuantPolicy as JQuantPolicy  # noqa: E402
from repro.launch.config import EngineConfig as JEngineConfig  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.models import ffn as JF  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.common import quantize_params as j_quantize_params  # noqa: E402
from repro_torch.cache import CacheConfig  # noqa: E402
from repro_torch.core.policy import QuantPolicy  # noqa: E402
from repro_torch.launch.config import EngineConfig  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402
from repro_torch.models import ffn as TF  # noqa: E402
from repro_torch.models.common import quantize_params  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

SCHEME = "fp5.33-e2m3"
PAGE, CAP = 8, 48


@pytest.fixture(scope="module")
def weights():
    """Unquantized f32 params of each reduced arch from the JAX package, and
    the same tree in numpy."""
    out = {}
    for arch in ("internvl2-1b", "musicgen-medium"):
        jp = j_init_params(jax.random.PRNGKey(0), get_config(arch).reduced())
        out[arch] = (jp, jax.tree.map(np.asarray, jp))
    return out


def first_divergence(got, want):
    return [next((t for t, (a, b) in enumerate(zip(g, w)) if a != b), None)
            for g, w in zip(got, want)]


# ------------------------------------------------------------------ (a) FFN
@pytest.mark.parametrize("scheme", [None, "fp5.33-e2m3", "fp4.25-e2m2"])
@pytest.mark.parametrize("act", ["gelu", "gelu_glu"])
def test_ffn_matches_the_compiled_reference(act, scheme):
    """gelu / gelu_glu FFNs bit-equal to the jitted JAX ffn_apply on bf16
    activations, with bf16 or packed AMS weights."""
    p = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                     JF.init_ffn(jax.random.PRNGKey(1), 128, 256, act))
    tp = params_from_numpy(jax.tree.map(np.asarray, p))
    assert set(tp) == ({"w_gate", "w_up", "w_down"} if act == "gelu_glu" else {"w_up", "w_down"})
    jpol = tpol = None
    if scheme:
        jpol = JQuantPolicy(scheme=scheme, impl="fused_ref", min_elements=1 << 10)
        tpol = QuantPolicy(scheme=scheme, impl="fused_ref", min_elements=1 << 10)
        p, tp = j_quantize_params(p, jpol), quantize_params(tp, tpol)
    x = (np.random.default_rng(0).standard_normal((3, 5, 128)) * 2).astype(np.float32)
    want = jax.jit(lambda p, x: JF.ffn_apply(p, x, act, jpol))(p, jnp.asarray(x, jnp.bfloat16))
    got = TF.ffn_apply(tp, torch.from_numpy(x).to(torch.bfloat16), act, tpol)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_gelu_matches_the_compiled_reference_on_every_bf16_value():
    """The activation alone over every finite bf16 value of magnitude
    1e-30 to 1e4 (below, XLA flushes denormal intermediates to zero)."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(np.int16)
    x = torch.from_numpy(bits).view(torch.bfloat16)
    a = x.float().abs()
    x = x[torch.isfinite(a) & (a > 1e-30) & (a < 1e4)]
    want = jax.jit(jax.nn.gelu)(jnp.asarray(x.view(torch.int16).numpy().view(jnp.bfloat16)))
    np.testing.assert_array_equal(TF.gelu(x).view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_init_ffn_draw_order():
    """A gelu MLP draws w_up then w_down from the generator, as the
    engine's layer-by-layer init draws them."""
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    p = TF.init_ffn(g1, 16, 32, "gelu")
    up = torch.randn((16, 32), generator=g2) / 4.0
    torch.testing.assert_close(p["w_up"]["w"], up, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown FFN activation"):
        TF.init_ffn(g1, 16, 32, "relu")


# -------------------------------------------------- (b) engine streams
def zoo_workload(cfg, seed=7):
    """Four requests on two slots; for a config with prefix embeds, three
    carry seeded normal embeddings and one is text only."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32) for n in (13, 9, 17, 11)]
    n = cfg.num_prefix_embeds
    embeds = [None] * 4
    if n:
        embeds = [rng.standard_normal((n, cfg.d_model)).astype(np.float32) if i != 2 else None
                  for i in range(4)]
    return prompts, embeds, [6, 5, 4, 6]


def serve(eng, prompts, embeds, max_tokens):
    hs = [eng.submit(p, m, prefix_embeds=e) for p, e, m in zip(prompts, embeds, max_tokens)]
    eng.run()
    return [list(h.tokens) for h in hs], eng.stats()


ZOO_CASES = [("paged_ams", 4, "kernel", "kernel"), ("paged_ams", 4, "fused_ref", "ref"),
             ("contiguous", 1, "kernel", "ref")]


@pytest.mark.parametrize("kind,chunk,impl,attn", ZOO_CASES)
@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium"])
def test_zoo_streams_match_reference(arch, kind, chunk, impl, attn, weights):
    """Greedy streams and tick accounting of reduced internvl2-1b (8 prefix
    embeds per request, one text-only request) and reduced musicgen-medium
    (a GELU MLP), the JAX engine (fused_ref matmuls, ref attention) against
    the port's; on AMS pages the kernel and ref lowerings round alike."""
    cfg = get_config(arch).reduced()
    prompts, embeds, max_tokens = zoo_workload(cfg)
    jeng = JServeEngine(JEngineConfig(
        arch=arch, reduced=True, scheme=SCHEME, impl="fused_ref", slots=2, capacity=CAP,
        prefill_chunk=chunk, cache=JCacheConfig(kind=kind, page_size=PAGE, impl="ref")),
        params=weights[arch][0])
    want, jstats = serve(jeng, prompts, embeds, max_tokens)
    eng = ServeEngine(EngineConfig(
        arch=arch, reduced=True, scheme=SCHEME, impl=impl, slots=2, capacity=CAP,
        prefill_chunk=chunk, device="cpu",
        cache=CacheConfig(kind=kind, page_size=PAGE, impl=attn)),
        params=params_from_numpy(weights[arch][1]))
    got, stats = serve(eng, prompts, embeds, max_tokens)
    assert got == want, f"{arch} {kind} C={chunk}: first diverging {first_divergence(got, want)}"
    for key in ("ticks", "tokens_generated", "ttft_ticks_p50", "latency_ticks_p50",
                "kv_bytes_per_token"):
        assert stats[key] == jstats[key], key
    if kind != "contiguous":
        assert stats["prefix_hit_pages"] == jstats["prefix_hit_pages"]


def test_prefix_embed_submission_rules(weights):
    """A wrong-width embed, or one for a config without a modality front
    end, raises ValueError as the reference's does; a request with embeds
    skips the prefix cache and counts its prefix among the prompt tokens."""
    kw = dict(reduced=True, slots=2, capacity=CAP, device="cpu",
              cache=CacheConfig(kind="paged_ams", page_size=PAGE))
    eng = ServeEngine(EngineConfig(arch="internvl2-1b", **kw),
                      params=params_from_numpy(weights["internvl2-1b"][1]))
    with pytest.raises(ValueError, match="d_model"):
        eng.submit([1, 2], 3, prefix_embeds=np.zeros((8, 64), np.float32))
    h = eng.submit(np.arange(1, 20), 3, prefix_embeds=np.zeros((8, 128), np.float32))
    assert not h.request.page_hashes and h.request.n_prefix == 8
    eng.run()
    assert h.done and len(h.tokens) == 3
    assert eng._m_prompt.value == 8 + 19
    plain = ServeEngine(EngineConfig(arch="musicgen-medium", **kw),
                        params=params_from_numpy(weights["musicgen-medium"][1]))
    with pytest.raises(ValueError, match="no modality frontend"):
        plain.submit([1, 2], 3, prefix_embeds=np.zeros((2, 128), np.float32))


# ------------------------------------------- (f) preempted prefix request
def test_prefix_request_preempted_resumes_like_reference(weights):
    """A prefix-embed request preempted mid-prefix (inside its embeds),
    then resumed, gives the stream of the JAX engine under the same forced
    preemption, and of the uninterrupted run; its embeds are fed again from
    the request."""
    arch = "internvl2-1b"
    cfg = get_config(arch).reduced()
    prompts, embeds, _ = zoo_workload(cfg)
    prompt, emb = prompts[0], embeds[0]

    def run(eng, preempt_after):
        h = eng.submit(prompt, 6, prefix_embeds=emb)
        for _ in range(preempt_after):
            eng.step()
        if preempt_after:
            eng.preempt(h.request.slot)
            assert h.status == "preempted"
        eng.run()
        return list(h.tokens), eng.stats()

    def port():
        return ServeEngine(EngineConfig(
            arch=arch, reduced=True, scheme=SCHEME, impl="kernel", slots=2, capacity=CAP,
            prefill_chunk=4, device="cpu", cache=CacheConfig(kind="paged_ams", page_size=4,
                                                             impl="kernel")),
            params=params_from_numpy(weights[arch][1]))

    jeng = JServeEngine(JEngineConfig(
        arch=arch, reduced=True, scheme=SCHEME, impl="fused_ref", slots=2, capacity=CAP,
        prefill_chunk=4, cache=JCacheConfig(kind="paged_ams", page_size=4)),
        params=weights[arch][0])
    want, jst = run(jeng, 1)
    got, st = run(port(), 1)
    assert got == want
    for key in ("preemptions", "resumes", "spill_pages", "ticks"):
        assert st[key] == jst[key] >= (1 if key != "ticks" else 0), key
    assert run(port(), 0)[0] == got


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium"])
def test_serving_params_from_a_seed(arch):
    """The engine's layer-by-layer init (`init_serving_params`, a GELU MLP's
    w_up and w_down drawn in `init_ffn`'s order) equals quantizing
    `init_params(seed)`."""
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import init_params

    ec = EngineConfig(arch=arch, reduced=True, impl="fused_ref", slots=2, capacity=CAP,
                      device="cpu", seed=3, cache=CacheConfig(kind="paged_ams", page_size=PAGE))
    a = ServeEngine(ec)
    b = ServeEngine(ec, params=init_params(3, t_get_config(arch).reduced()))
    assert ("w_gate" in a.params["layers"]["sub0"]["ffn"]) == (arch == "internvl2-1b")
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert x.dtype == y.dtype and torch.equal(x, y)

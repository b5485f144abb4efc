"""Port parity, the slice as a whole: weights, decode steps and served streams
of the reduced qwen2-7b, PyTorch port against the JAX package on the CPU.

The JAX side runs as its engine runs it (the decode step compiled by XLA);
the port reproduces the two places where that compilation changes bf16/f32
rounding (the KV-scale reciprocal and the residual add fused into the
norm), so logits and greedy streams agree exactly here. Three paths: FP5.33
weights over AMS pages (K1, K2), FP4.25 weights over AMS pages (K1b, K2),
and the FP16 baseline, bf16 weights over bf16 pages (K3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: more intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cache import CacheConfig as JCacheConfig  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.policy import QuantPolicy as JQuantPolicy  # noqa: E402
from repro.launch.config import EngineConfig as JEngineConfig  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_cache as j_make_cache  # noqa: E402
from repro.models.common import quantize_params as j_quantize_params  # noqa: E402
from repro_torch.cache import CacheConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.policy import QuantPolicy  # noqa: E402
from repro_torch.launch.config import EngineConfig  # noqa: E402
from repro_torch.launch.engine import ServeEngine, prepare_params  # noqa: E402
from repro_torch.launch.sampling import SamplingParams  # noqa: E402
from repro_torch.models import decode_step, init_params, make_cache  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402

SCHEME = "fp5.33-e2m3"
PAGE, CAP = 8, 32
# the slice-2 paths: (weight scheme, cache kind)
NEW_PATHS = [("fp4.25-e2m2", "paged_ams"), ("fp16", "paged_bf16")]


@pytest.fixture(scope="module")
def jax_params():
    """Unquantized f32 params of the reduced qwen2-7b from the JAX package."""
    return j_init_params(jax.random.PRNGKey(0), get_config("qwen2-7b").reduced())


@pytest.fixture(scope="module")
def np_params(jax_params):
    return jax.tree.map(np.asarray, jax_params)


def serving_pair(jax_params, np_params, scheme=SCHEME):
    """The reference engine's weight preparation on both sides (``fp16``:
    bf16 weights, no policy)."""
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, jax_params)
    if scheme == "fp16":
        return jp, None, prepare_params(params_from_numpy(np_params), None), None
    jpol = JQuantPolicy(scheme=scheme, impl="fused_ref", min_elements=1 << 10)
    jp = j_quantize_params(jp, jpol)
    tpol = QuantPolicy(scheme=scheme, impl="fused_ref", min_elements=1 << 10)
    tp = prepare_params(params_from_numpy(np_params), tpol)
    return jp, jpol, tp, tpol


def test_serving_params_bit_equal(jax_params, np_params):
    check_serving_params(jax_params, np_params, SCHEME)


@pytest.mark.parametrize("scheme", ["fp4.25-e2m2", "fp16"])
def test_serving_params_bit_equal_new_schemes(scheme, jax_params, np_params):
    check_serving_params(jax_params, np_params, scheme)


def check_serving_params(jax_params, np_params, scheme):
    jp, _, tp, _ = serving_pair(jax_params, np_params, scheme)

    def walk(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
            return
        an = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
        bn = (b.float() if b.dtype == torch.bfloat16 else b).numpy()
        assert an.shape == bn.shape and str(b.dtype).endswith(str(a.dtype)), path
        np.testing.assert_array_equal(an, bn, err_msg=path)

    walk(jp, tp, "")


@pytest.mark.parametrize("chunk", [1, 4])
def test_decode_step_logits_match_reference(chunk, jax_params, np_params):
    check_decode_step_logits(chunk, jax_params, np_params, SCHEME, "paged_ams")


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("scheme,kind", NEW_PATHS)
def test_decode_step_logits_match_reference_new_paths(scheme, kind, chunk, jax_params,
                                                      np_params):
    check_decode_step_logits(chunk, jax_params, np_params, scheme, kind)


def check_decode_step_logits(chunk, jax_params, np_params, scheme, kind):
    """Five ticks of the decode step (ref attention on both sides) from the
    same weights: logits of the active slots within one bf16 ulp of the
    largest logits, pool bytes bit-equal. The FP16 path's projections are
    bf16 x bf16 products (no AMS weights, whose f32 blocked product the
    port reproduces exactly); XLA and torch sum them in different orders,
    which rounds a few bf16 outputs one ulp apart at 12 rows (chunk 4), and
    the flips carry through the layers: there logits are held to 5e-2
    (measured 0.023, 3 bf16 ulps of |logit| < 4) with equal argmax, and
    pool values likewise (measured 0.018; all but 3 of 12288 within one
    bf16 ulp)."""
    cfg = get_config("qwen2-7b").reduced()
    tcfg = t_get_config("qwen2-7b").reduced()
    jp, jpol, tp, tpol = serving_pair(jax_params, np_params, scheme)
    B = 3
    jcc = JCacheConfig(kind=kind, page_size=PAGE).sized(capacity=CAP, slots=B)
    tcc = CacheConfig(kind=kind, page_size=PAGE).sized(capacity=CAP, slots=B)
    bt = np.arange(B * jcc.max_pages_per_seq, dtype=np.int32).reshape(B, -1)
    step = jax.jit(lambda p, tok, c, pos, nv: j_decode_step(
        p, tok, c, pos, cfg, policy=jpol, block_tables=jnp.asarray(bt), cache_cfg=jcc,
        nvalid=nv))
    step1 = jax.jit(lambda p, tok, c, pos: j_decode_step(
        p, tok, c, pos, cfg, policy=jpol, block_tables=jnp.asarray(bt), cache_cfg=jcc))
    jc = j_make_cache(cfg, B, CAP, cache_cfg=jcc)
    tc = make_cache(tcfg, cache_cfg=tcc)
    rng = np.random.default_rng(chunk)
    pos = np.array([0, 2, -1], np.int32)                  # slot 2 idle
    for _ in range(5):
        tok = rng.integers(0, 512, (B, chunk)).astype(np.int32)
        nv = np.array([chunk, max(chunk - 1, 1), 0], np.int32)
        if chunk == 1:
            lj, jc = step1(jp, jnp.asarray(tok[:, 0]), jc, jnp.asarray(pos))
            lt, tc = decode_step(tp, torch.from_numpy(tok[:, 0]), tc, torch.from_numpy(pos),
                                 tcfg, policy=tpol, block_tables=torch.from_numpy(bt),
                                 cache_cfg=tcc)
        else:
            lj, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(pos), jnp.asarray(nv))
            lt, tc = decode_step(tp, torch.from_numpy(tok), tc, torch.from_numpy(pos), tcfg,
                                 policy=tpol, block_tables=torch.from_numpy(bt),
                                 cache_cfg=tcc, nvalid=torch.from_numpy(nv))
        # active slots; one bf16 ulp of the largest logits as the tolerance
        lt, lj = lt.numpy()[:2], np.asarray(lj)[:2]
        np.testing.assert_allclose(lt, lj, rtol=0, atol=5e-2 if scheme == "fp16" else 2e-2)
        assert (lt.argmax(-1) == lj.argmax(-1)).all()
        pos = pos + np.where(pos >= 0, nv, 0)
    jl, tl = jax.tree.leaves(jc["layers"]["sub0"]), tree_leaves(tc["layers"]["sub0"])
    assert len(jl) == len(tl) == (2 if kind == "paged_bf16" else 6)
    for a, b in zip(jl, tl):      # same dict order on both sides: k, v (x hi, lsb, scale)
        if scheme == "fp16":
            np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                       rtol=2 ** -7, atol=5e-2)
        else:
            np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                          b.view(torch.uint8).numpy())


def workload():
    """Four requests on two slots; the last one arrives in the queue with
    the first one's first page (8 tokens) as its prompt prefix."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, int(n)).astype(np.int32) for n in (13, 9, 17, 11)]
    prompts[3][:PAGE] = prompts[0][:PAGE]
    return prompts, [6, 5, 4, 6]


def serve(eng, prompts, max_tokens):
    hs = [eng.submit(p, m) for p, m in zip(prompts, max_tokens)]
    eng.run()
    return [list(h.tokens) for h in hs], eng.stats()


@pytest.mark.parametrize("chunk", [1, 4])
def test_engine_streams_match_reference(chunk, jax_params, np_params):
    check_engine_streams(chunk, jax_params, np_params, SCHEME, "paged_ams")


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("scheme,kind", NEW_PATHS)
def test_engine_streams_match_reference_new_paths(scheme, kind, chunk, jax_params, np_params):
    check_engine_streams(chunk, jax_params, np_params, scheme, kind)


def first_divergence(got, want):
    return [next((t for t, (a, b) in enumerate(zip(g, w)) if a != b), None)
            for g, w in zip(got, want)]


def check_engine_streams(chunk, jax_params, np_params, scheme, kind):
    """The port's engine, impl pairs (fused_ref, ref) and (kernel, kernel),
    against the JAX engine's greedy streams and tick accounting. The port's
    kernel attention path is compared with the JAX engine that runs the
    matching Pallas lowering in interpret mode: for bf16 pages K3 rounds p
    to bf16 at the running max, as the TPU kernel does, while the ref path
    rounds it at the global max (the first stream diverges at its token 4
    on this workload, for chunk 1 and 4; ROADMAP queue 3)."""
    prompts, max_tokens = workload()

    def reference(attn):
        jeng = JServeEngine(JEngineConfig(
            arch="qwen2-7b", reduced=True, scheme=scheme, impl="fused_ref", slots=2,
            capacity=CAP, prefill_chunk=chunk,
            cache=JCacheConfig(kind=kind, page_size=PAGE, impl=attn)), params=jax_params)
        return (*serve(jeng, prompts, max_tokens), jeng.signature)

    want_ref = reference("ref")
    # AMS pages: the kernel and ref lowerings round alike (f32 lattice values)
    want_kernel = reference("pallas_interpret") if kind == "paged_bf16" else want_ref
    for impl, attn in (("fused_ref", "ref"), ("kernel", "kernel")):
        want, jstats, jsig = want_kernel if attn == "kernel" else want_ref
        eng = ServeEngine(EngineConfig(
            arch="qwen2-7b", reduced=True, scheme=scheme, impl=impl, slots=2, capacity=CAP,
            prefill_chunk=chunk, device="cpu",
            cache=CacheConfig(kind=kind, page_size=PAGE, impl=attn)),
            params=params_from_numpy(np_params))
        got, stats = serve(eng, prompts, max_tokens)
        assert got == want, (f"{scheme}/{kind} {impl}/{attn} C={chunk}: first diverging "
                             f"token {first_divergence(got, want)}")
        assert stats["prefix_hit_pages"] == jstats["prefix_hit_pages"] >= 1
        for key in ("ticks", "tokens_generated", "ttft_ticks_p50", "latency_ticks_p50",
                    "kv_bytes_per_token"):
            assert stats[key] == jstats[key], key
        for key in ("arch", "scheme", "cache", "kv_scheme", "slots", "chunk"):
            assert eng.signature[key] == jsig[key], key
        assert eng.cache_cfg.content_key == JCacheConfig(kind=kind).content_key
    if kind == "paged_bf16":
        assert first_divergence(want_kernel[0], want_ref[0]) == [4, None, None, None]


def test_engine_builds_the_same_params_from_a_seed():
    """ServeEngine(params=None) initialises and quantizes layer by layer from
    torch.Generator(seed); that equals quantizing init_params(seed)."""
    cfg = t_get_config("qwen2-7b").reduced()
    ec = EngineConfig(reduced=True, impl="fused_ref", slots=2, capacity=CAP, device="cpu",
                      seed=3, cache=CacheConfig(kind="paged_ams", page_size=PAGE))
    a = ServeEngine(ec)
    b = ServeEngine(ec, params=init_params(3, cfg))
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    prompts, max_tokens = workload()
    assert serve(a, prompts, max_tokens)[0] == serve(b, prompts, max_tokens)[0]


def cfg_(**kw):
    base = dict(reduced=True, slots=2, capacity=CAP, device="cpu",
                cache=CacheConfig(kind="paged_ams", page_size=PAGE))
    base.update(kw)
    return EngineConfig(**base)


@pytest.mark.parametrize("kw,match", [
    (dict(speculate_k=2, drafter="self"), None),
    (dict(mesh=object()), "mesh"),
    (dict(speculate_k=2, drafter="self-full"), None),
])
def test_missing_features_raise_not_implemented(kw, match):
    """Features still to port (meshes) raise at construction, naming what
    they need; the self drafters, ported, are built by the engine from its
    own params: the first layer ("self") or the whole stack ("self-full")."""
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            cfg_(**kw)
        return
    from repro_torch.launch.speculative import SelfDrafter
    eng = ServeEngine(cfg_(**kw))
    d = eng.drafter
    assert isinstance(d, SelfDrafter) and d.capacity == CAP
    assert d.draft_cfg.num_layers == (1 if kw["drafter"] == "self" else eng.cfg.num_layers)
    assert d.draft_params["lm_head"] is eng.params["lm_head"]
    assert len(d.propose(np.arange(1, 9, dtype=np.int32), 2)) == 2


def test_missing_request_features_raise_not_implemented():
    """Request features still to port raise; prefix embeds, ported, are
    accepted where the config has a modality front end and refused with
    ValueError, as the reference refuses them, for a config without one or
    at the wrong width; preemption over a contiguous cache raises as the
    reference's does, and a priority over a contiguous cache only orders the
    queue (no preemption), as in the reference."""
    with pytest.raises(NotImplementedError, match="meshes"):
        cfg_(mesh=object())
    eng = ServeEngine(cfg_())
    with pytest.raises(ValueError, match="no modality frontend"):
        eng.submit([1, 2, 3], 4, prefix_embeds=np.zeros((2, 128), np.float32))
    vlm = ServeEngine(cfg_(arch="internvl2-1b"))
    with pytest.raises(ValueError, match="d_model"):
        vlm.submit([1, 2, 3], 4, prefix_embeds=np.zeros((2, 64), np.float32))
    h = vlm.submit([1, 2, 3], 4, prefix_embeds=np.zeros((2, 128), np.float32))
    assert h.result() and h.done and h.request.n_prefix == 2
    with pytest.raises(NotImplementedError, match="dense GQA"):
        ServeEngine(cfg_(arch="minicpm3-4b"))
    ticks = []
    for eng in (ServeEngine(cfg_(slots=1, cache=None)),
                JServeEngine(JEngineConfig(arch="qwen2-7b", reduced=True, slots=1,
                                           capacity=CAP))):
        assert not eng.preempt_enabled
        low = eng.submit(np.arange(1, 6), 3)
        eng.step()
        with pytest.raises(RuntimeError, match="paged cache"):
            eng.preempt(low.request.slot)
        high = eng.submit(np.arange(7, 10), 2, priority=5)
        eng.step()
        assert eng.preemptions == 0 and high.status == "queued" and low.status == "prefill"
        eng.run()
        assert low.finish_tick < high.finish_tick and eng.stats()["preemptions"] == 0
        ticks.append((low.finish_tick, high.finish_tick, low.tokens, high.tokens))
    assert ticks[0][:2] == ticks[1][:2]


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg_(device="cuda"))


def test_entry_points_default_to_the_card():
    """EngineConfig and serve.generate run on the card unless the caller asks
    for the CPU; without a card they raise rather than fall back."""
    from repro_torch.launch.serve import generate
    assert EngineConfig(cache=CacheConfig(kind="paged_bf16")).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for scheme in ("fp5.33-e2m3", "fp4.25-e2m2", "fp16"):
        with pytest.raises(RuntimeError, match="cuda"):
            generate("qwen2-7b", scheme=scheme, batch=1, prompt_len=4, gen_tokens=1)


@pytest.mark.parametrize("cache", ["paged", None], ids=["paged", "default"])
@pytest.mark.parametrize("scheme", ["fp16", "fp4.25-e2m2"])
def test_serve_generate_pairs_cache_with_scheme(scheme, cache):
    """serve.generate with ``cache="paged"`` serves fp16 weights over bf16
    pages and quantized ones over AMS pages; by default it serves the
    contiguous bf16 cache for every scheme, as the reference's generate
    does. Kernel impls on CPU tensors run the plain versions and give the
    non-kernel impls' tokens."""
    from repro_torch.launch.serve import generate
    kw = dict(scheme=scheme, batch=2, prompt_len=6, gen_tokens=3, prefill_chunk=4,
              device="cpu", **({} if cache is None else dict(cache=cache)))
    toks, stats = generate("qwen2-7b", impl="kernel", attn_impl="kernel", **kw)
    want = ("contiguous" if cache is None else
            "paged_bf16" if scheme == "fp16" else "paged_ams")
    # reduced qwen2-7b: 2 layers x (k, v) x 2 kv heads x hd 32, in bf16 (2 bytes per
    # value) or packed AMS-e2m2 (16 hi bytes + 4 lsb bytes + 4 scale bytes per vector)
    assert stats["kv_bytes_per_token"] == {"contiguous": 512, "paged_bf16": 512,
                                           "paged_ams": 192}[want]
    assert ("free_pages" in stats) == (cache == "paged")
    ref, _ = generate("qwen2-7b", impl="fused_ref", attn_impl="ref", **kw)
    assert toks.shape == (2, 3) and (toks == ref).all()


def test_stop_token_ends_stream_early():
    eng = ServeEngine(cfg_(impl="kernel"))
    free = eng.submit(np.arange(5), 6)
    eng.run()
    stop = free.tokens[2]
    eng2 = ServeEngine(cfg_(impl="kernel"))
    h = eng2.submit(np.arange(5), 6, sampling=SamplingParams(stop_token_ids=(stop,)))
    assert h.result() == free.tokens[:free.tokens.index(stop) + 1]
    assert h.finish_reason == "stop"

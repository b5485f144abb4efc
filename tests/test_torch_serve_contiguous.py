"""Port parity, the slice as a whole: the reduced qwen2-7b and minicpm3-4b
served over contiguous caches (the JAX engine's default cache), PyTorch
port against the JAX package on the CPU.

Each port impl is held against the JAX engine with the matching contiguous
lowering: the port's ``ref`` attention against the JAX ``ref`` tier
(flash-decode, p rounded at the global max), its ``kernel`` attention
(K4 / K5's plain versions here) against the JAX Pallas lowering in interpret
mode (p rounded at each block's running max, and the scaled q kept in f32
as XLA compiles it). The two JAX lowerings give different greedy streams on
both models; each port impl gives its counterpart's streams exactly.
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
from repro_torch.models import decode_step, make_cache  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402

SCHEME = "fp5.33-e2m3"
CAP = 32
ARCHS = ["qwen2-7b", "minicpm3-4b"]
# port impl (matmul, attention) -> the JAX contiguous lowering it reproduces
JAX_ATTN = {"ref": "ref", "kernel": "pallas_interpret"}


@pytest.fixture(scope="module")
def models():
    """Unquantized f32 params of each reduced arch from the JAX package, and
    the same tree as numpy arrays."""
    out = {}
    for arch in ARCHS:
        jp = j_init_params(jax.random.PRNGKey(0), get_config(arch).reduced())
        out[arch] = (jp, jax.tree.map(np.asarray, jp))
    return out


def serving_pair(jax_params, np_params):
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, jax_params)
    jpol = JQuantPolicy(scheme=SCHEME, impl="fused_ref", min_elements=1 << 10)
    tpol = QuantPolicy(scheme=SCHEME, impl="fused_ref", min_elements=1 << 10)
    return (j_quantize_params(jp, jpol), jpol,
            prepare_params(params_from_numpy(np_params), tpol), tpol)


def test_mla_serving_params_bit_equal(models):
    """The MLA tree carried across (`params_from_numpy`) and quantized by the
    same policy: every leaf bit-equal, the absorbed factors W_uk / W_uv
    packed like every other projection."""
    jp, _, tp, _ = serving_pair(*models["minicpm3-4b"])

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
    assert set(tp["layers"]["sub0"]["attn"]["w_uk"]) == {"hi", "lsb", "scale"}


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match_reference(arch, chunk, impl, models):
    """Five ticks of the decode step over a contiguous cache (slot 2 idle),
    the port's attention impl against the compiled JAX step with the
    matching lowering: logits of the active slots within one bf16 ulp of the
    largest logits with equal argmax, caches bit-equal. (The logits are
    exact but for minicpm3-4b at chunk 4, where the bf16 lm_head product
    rounds a few logits one ulp apart from XLA's: measured <= 0.004.)"""
    cfg, tcfg = get_config(arch).reduced(), t_get_config(arch).reduced()
    jp, jpol, tp, tpol = serving_pair(*models[arch])
    B = 3
    jcc = JCacheConfig(kind="contiguous", impl=JAX_ATTN[impl])
    tcc = CacheConfig(kind="contiguous", impl=impl)
    step = jax.jit(lambda p, tok, c, pos, nv: j_decode_step(
        p, tok, c, pos, cfg, policy=jpol, cache_cfg=jcc, nvalid=nv))
    step1 = jax.jit(lambda p, tok, c, pos: j_decode_step(p, tok, c, pos, cfg, policy=jpol,
                                                         cache_cfg=jcc))
    jc = j_make_cache(cfg, B, CAP, cache_cfg=jcc)
    tc = make_cache(tcfg, B, CAP, cache_cfg=tcc)
    rng = np.random.default_rng(chunk)
    pos = np.array([0, 2, -1], np.int32)
    for _ in range(5):
        tok = rng.integers(0, 512, (B, chunk)).astype(np.int32)
        nv = np.array([chunk, max(chunk - 1, 1), 0], np.int32)
        if chunk == 1:
            lj, jc = step1(jp, jnp.asarray(tok[:, 0]), jc, jnp.asarray(pos))
            lt, tc = decode_step(tp, torch.from_numpy(tok[:, 0]), tc, torch.from_numpy(pos),
                                 tcfg, policy=tpol, cache_cfg=tcc)
        else:
            lj, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(pos), jnp.asarray(nv))
            lt, tc = decode_step(tp, torch.from_numpy(tok), tc, torch.from_numpy(pos), tcfg,
                                 policy=tpol, cache_cfg=tcc, nvalid=torch.from_numpy(nv))
        lt, lj = lt.numpy()[:2], np.asarray(lj)[:2]
        np.testing.assert_allclose(lt, lj, rtol=0, atol=2e-2)
        assert (lt.argmax(-1) == lj.argmax(-1)).all()
        pos = pos + np.where(pos >= 0, nv, 0)
    jl, tl = jax.tree.leaves(jc["layers"]["sub0"]), tree_leaves(tc["layers"]["sub0"])
    assert len(jl) == len(tl) == (1 if arch == "minicpm3-4b" else 2)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint16),
                                      b.view(torch.int16).numpy().view(np.uint16))


BIG_CAP = 40960      # the reference plan's block is 20480 keys for both reduced models


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_over_several_reference_blocks(arch, chunk, models):
    """A capacity the reference plan splits into two key blocks, over a
    cache filled with the same random rows in both packages, and a slot
    whose length reaches into the second block: the port's ``kernel`` step
    (p rounded at each block's running max) against the compiled JAX Pallas
    step in interpret mode, logits and written caches bit-equal."""
    from repro_torch.kernels.tuning import reference_block_kv

    cfg, tcfg = get_config(arch).reduced(), t_get_config(arch).reduced()
    jp, jpol, tp, tpol = serving_pair(*models[arch])
    jcc = JCacheConfig(kind="contiguous", impl="pallas_interpret")
    tcc = CacheConfig(kind="contiguous", impl="kernel")
    B, H = 2, cfg.num_heads
    jc = j_make_cache(cfg, B, BIG_CAP, cache_cfg=jcc)
    rng = np.random.default_rng(11 + chunk)
    leaves = {}
    for name, leaf in jc["layers"]["sub0"].items():
        hd = leaf.shape[-1]
        hd_v = cfg.kv_lora_rank if arch == "minicpm3-4b" else hd
        rows = chunk * H // leaf.shape[-2]
        assert reference_block_kv(rows=rows, hd=hd, hd_v=hd_v, s_max=BIG_CAP) < BIG_CAP // 1.5
        a = np.asarray(jnp.asarray(0.5 * rng.standard_normal(leaf.shape, np.float32),
                                   jnp.bfloat16))
        leaves[name] = a
    jc = {"layers": {"sub0": {n: jnp.asarray(a) for n, a in leaves.items()}}}
    tc = {"layers": {"sub0": {n: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                              for n, a in leaves.items()}}}
    pos = np.array([24000, 9000], np.int32)               # slot 0 reaches block 2
    tok = rng.integers(0, 512, (B, chunk)).astype(np.int32)
    nv = np.array([chunk, max(chunk - 1, 1)], np.int32)
    if chunk == 1:
        lj, jc = jax.jit(lambda p, t, c, q: j_decode_step(
            p, t, c, q, cfg, policy=jpol, cache_cfg=jcc))(jp, jnp.asarray(tok[:, 0]), jc,
                                                           jnp.asarray(pos))
        lt, tc = decode_step(tp, torch.from_numpy(tok[:, 0]), tc, torch.from_numpy(pos), tcfg,
                             policy=tpol, cache_cfg=tcc)
    else:
        lj, jc = jax.jit(lambda p, t, c, q, n: j_decode_step(
            p, t, c, q, cfg, policy=jpol, cache_cfg=jcc, nvalid=n))(
                jp, jnp.asarray(tok), jc, jnp.asarray(pos), jnp.asarray(nv))
        lt, tc = decode_step(tp, torch.from_numpy(tok), tc, torch.from_numpy(pos), tcfg,
                             policy=tpol, cache_cfg=tcc, nvalid=torch.from_numpy(nv))
    np.testing.assert_array_equal(lt.float().numpy(), np.asarray(lj.astype(jnp.float32)))
    for name in leaves:
        np.testing.assert_array_equal(
            np.asarray(jc["layers"]["sub0"][name]).view(np.uint16),
            tc["layers"]["sub0"][name].view(torch.int16).numpy().view(np.uint16))


def workload():
    """Four requests on two slots, so two are admitted into reused slots."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, int(n)).astype(np.int32) for n in (13, 9, 17, 11)]
    return prompts, [6, 5, 4, 6]


def serve(eng):
    prompts, max_tokens = workload()
    hs = [eng.submit(p, m) for p, m in zip(prompts, max_tokens)]
    eng.run()
    return [list(h.tokens) for h in hs], eng.stats()


def first_divergence(got, want):
    return [next((t for t, (a, b) in enumerate(zip(g, w)) if a != b), None)
            for g, w in zip(got, want)]


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_reference(arch, chunk, models):
    """The port's engine over the default cache (``cache=None``) with impl
    pairs (fused_ref, ref) and (kernel, kernel) against the JAX engine's
    greedy streams and tick accounting with the matching contiguous
    lowering. The two JAX lowerings disagree: the first stream diverges at
    its first token (minicpm3-4b) or its second (qwen2-7b), at chunk 1 and
    4; ROADMAP queue 3."""
    jax_params, np_params = models[arch]
    want = {}
    for impl in ("ref", "kernel"):
        jeng = JServeEngine(JEngineConfig(
            arch=arch, reduced=True, scheme=SCHEME, impl="fused_ref", slots=2, capacity=CAP,
            prefill_chunk=chunk, cache=JCacheConfig(kind="contiguous", impl=JAX_ATTN[impl])),
            params=jax_params)
        want[impl] = (*serve(jeng), jeng.signature)
    assert first_divergence(want["kernel"][0], want["ref"][0]) == (
        [0, None, None, None] if arch == "minicpm3-4b" else [1, None, None, None])
    for impl, attn in (("fused_ref", "ref"), ("kernel", "kernel")):
        jtoks, jstats, jsig = want[attn]
        eng = ServeEngine(EngineConfig(arch=arch, reduced=True, scheme=SCHEME, impl=impl,
                                       slots=2, capacity=CAP, prefill_chunk=chunk,
                                       device="cpu", cache=CacheConfig(impl=attn)),
                          params=params_from_numpy(np_params))
        got, stats = serve(eng)
        assert got == jtoks, (f"{arch} {impl}/{attn} C={chunk}: first diverging token "
                              f"{first_divergence(got, jtoks)}")
        for key in ("ticks", "tokens_generated", "ttft_ticks_p50", "latency_ticks_p50",
                    "kv_bytes_per_token", "kv_compression_vs_bf16", "queue_depth"):
            assert stats[key] == jstats[key], key
        assert "free_pages" not in stats and "free_pages" not in jstats
        for key in ("arch", "scheme", "cache", "kv_scheme", "slots", "chunk"):
            assert eng.signature[key] == jsig[key], key


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_none_builds_a_contiguous_engine(arch):
    """``EngineConfig(cache=None)`` serves the contiguous cache, as the JAX
    EngineConfig does: no page allocator, no block tables, a [L, slots,
    capacity, ...] cache, slots zeroed on admission."""
    eng = ServeEngine(EngineConfig(arch=arch, reduced=True, impl="kernel", slots=2,
                                   capacity=CAP, prefill_chunk=4, device="cpu"))
    assert eng.cache_cfg.kind == "contiguous" and not eng.cache_cfg.paged
    assert eng.alloc is None and eng.block_tables is None
    assert eng.signature["cache"] == "contiguous"
    leaves = tree_leaves(eng.cache["layers"])
    assert all(t.shape[:3] == (eng.cfg.num_layers, 2, CAP) and t.dtype == torch.bfloat16
               for t in leaves)
    h = eng.submit(np.arange(1, 12), 4)
    for t in leaves:
        t.fill_(1.0)                                # stale rows of an earlier request
    eng.step()                                      # admits into slot 0 and zeroes it
    assert all(float(t[:, 1].float().min()) == 1.0 for t in leaves)     # slot 1 untouched
    assert all(bool((t[:, 0, 4:] == 0).all()) for t in leaves)          # slot 0 zeroed
    assert len(h.result()) == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_generate_default_matches_reference(arch, models):
    """serve.generate's default cache is the contiguous one, as in the JAX
    package's generate: the same greedy tokens from the same weights."""
    from repro.launch.serve import generate as j_generate
    from repro_torch.launch.serve import generate

    jax_params, np_params = models[arch]
    kw = dict(reduced=True, scheme=SCHEME, impl="fused_ref", batch=2, prompt_len=6,
              gen_tokens=3)
    want, jstats = j_generate(arch, params=jax_params, **kw)
    got, stats = generate(arch, params=params_from_numpy(np_params), attn_impl="ref",
                          device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    assert stats["kv_bytes_per_token"] == jstats["kv_bytes_per_token"]
    assert "free_pages" not in stats

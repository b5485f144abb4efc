"""Port parity of MoE serving (reduced llama4-scout-17b-16e: 4 experts,
top-1, a shared expert of 256; reduced dbrx-132b: 4 experts, top-2, no
shared expert) against the JAX package's engine, decode step and
`forward_seq` on the CPU, with the same numpy-made weights.

Four serving paths: FP4.25 and FP5.33 weights over AMS-e2m2 pages, FP16
(bf16 weights) over bf16 pages, and FP4.25 weights over the contiguous
cache; the one-token step and the ragged chunk of 4. The steps run at
three layers (`ModelConfig.reduced(num_layers=3)`), the engines at the
reference's reduced two (its engine builds `reduced()` configs only).

Exact: tick accounting and cost keys of the port's engine, impl pairs
(fused_ref, ref) and (kernel, kernel) (the kernels' plain versions here),
against the JAX engine with the matching lowering; the greedy streams, up
to a token where the reference's own logits tie exactly (the request
replayed through its jitted step; one reduced-DBRX stream meets such a
tie, where the port's engine logits, an ulp apart, take the other token);
`init_serving_params` against ``prepare_params(init_params(seed))``; the
load-balance loss that `forward_seq` sums over the layers; the decode
step's logits and pool bytes on the AMS and contiguous paths (the CPU
`rms_norm` and the plain attention's bf16 q . k and p . v sum in XLA's
order and take XLA's rsqrt, `core.xla_math`). The bf16 dot order is
copied only on a CPU with AVX512-BF16 (`xla_math.pairs_bf16_dot`); on
another CPU the AMS and contiguous logits are held to LOGIT_TOL with equal
argmax, the pools to all but POOL_FLIPS of their bytes, and a stream may
part from the reference's where its logits are a near-tie (within
LOGIT_TOL of the largest). Within stated tolerances:
the FP16 path's step logits (LOGIT_TOL; measured 9.95e-3 of the largest)
and bf16 pages (BF16_REL / BF16_ATOL), whose bf16 x bf16 projections
round a few values one ulp apart, as on the dense FP16 path
(`test_torch_engine.py`); `forward_seq`'s logits (FWD_LOGIT_TOL; measured
3.0e-5 of the largest, Scout: the blocked products of its packed weights
and the sequence attention's blocks are not all XLA's order).
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
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward_seq as j_forward_seq  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_cache as j_make_cache  # noqa: E402
from repro.models.common import quantize_params as j_quantize_params  # noqa: E402
from repro_torch.cache import CacheConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.policy import QuantPolicy  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.core.xla_math import pairs_bf16_dot  # noqa: E402
from repro_torch.launch.config import EngineConfig  # noqa: E402
from repro_torch.launch.engine import ServeEngine, init_serving_params, prepare_params  # noqa: E402
from repro_torch.models import decode_step, forward_seq, init_params, make_cache  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

SCOUT, DBRX = "llama4-scout-17b-16e", "dbrx-132b"
ARCHS = [SCOUT, DBRX]
PAGE, CAP = 8, 32
# (weight scheme, cache kind, prefill chunk), each path on one arch for the
# step and on the other for the engine's streams
PATHS = [("fp4.25-e2m2", "paged_ams", 4), ("fp5.33-e2m3", "paged_ams", 1),
         ("fp16", "paged_bf16", 4), ("fp4.25-e2m2", "contiguous", 4)]
STEP_CASES = [(a, *p) for a, p in zip((SCOUT, DBRX, SCOUT, DBRX), PATHS)]
STREAM_CASES = [(a, *p) for a, p in zip((DBRX, SCOUT, DBRX, SCOUT), PATHS)]
LOGIT_TOL = 2 ** -6      # FP16 step logits (any, without the bf16 dot order)
FWD_LOGIT_TOL = 2 ** -13     # forward_seq logits: max |d| / max |logit|
POOL_FLIPS = 0.02        # share of pool bytes that may differ without the bf16 dot order
BF16_DOT = pairs_bf16_dot(torch.zeros(2, dtype=torch.bfloat16),
                          torch.zeros(2, dtype=torch.bfloat16))
BF16_REL, BF16_ATOL = 2 ** -7, 5e-2    # bf16 caches, element by element (as FP16's)


def configs(arch, layers=None):
    over = {} if layers is None else dict(num_layers=layers)
    return get_config(arch).reduced(**over), t_get_config(arch).reduced(**over)


def numpy_params(cfg, seed=0):
    return jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(seed), cfg))


def served(npar, scheme, jimpl="fused_ref", impl="fused_ref"):
    """(jax params, jax policy, port params, port policy) as the engines
    prepare them: every leaf of ndim >= 2 in bf16 (the routers too), then
    PTQ; ``fp16`` keeps bf16 weights and no policy."""
    jp = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16) if x.ndim >= 2
                      else jnp.asarray(x), npar)
    if scheme == "fp16":
        return jp, None, prepare_params(params_from_numpy(npar), None), None
    jpol = JQuantPolicy(scheme=scheme, impl=jimpl, min_elements=1 << 10)
    tpol = QuantPolicy(scheme=scheme, impl=impl, min_elements=1 << 10)
    return (j_quantize_params(jp, jpol), jpol,
            prepare_params(params_from_numpy(npar), tpol), tpol)


@pytest.mark.parametrize("arch,scheme,kind,chunk", STEP_CASES)
def test_decode_step_matches_reference(arch, scheme, kind, chunk):
    """Five ticks of the jitted JAX decode step against the port's at three
    layers (fused_ref matmuls, ref attention; slot 2 idle): logits of the
    live slots bit-equal (FP16, or a CPU without the bf16 dot order: within
    LOGIT_TOL of the largest with equal argmax), and the pools (every
    layer's pages, or the live slots' contiguous rows) bit-equal (AMS
    planes; all but POOL_FLIPS of the bytes without the bf16 dot order) or
    within BF16_REL of each
    value plus BF16_ATOL (bf16 pages and caches, the rule of the dense
    FP16 path)."""
    cfg, tcfg = configs(arch, layers=3)
    jp, jpol, tp, tpol = served(numpy_params(cfg), scheme)
    B = 3
    paged = kind != "contiguous"
    jcc = (JCacheConfig(kind=kind, page_size=PAGE).sized(capacity=CAP, slots=B) if paged
           else None)
    tcc = (CacheConfig(kind=kind, page_size=PAGE).sized(capacity=CAP, slots=B) if paged
           else None)
    bt = (np.arange(B * jcc.max_pages_per_seq, dtype=np.int32).reshape(B, -1) if paged
          else None)
    jkw = dict(block_tables=jnp.asarray(bt), cache_cfg=jcc) if paged else {}
    tkw = dict(block_tables=torch.from_numpy(bt), cache_cfg=tcc) if paged else {}
    if chunk == 1:
        step = jax.jit(lambda p, tok, c, pos, nv: j_decode_step(p, tok[:, 0], c, pos, cfg,
                                                                policy=jpol, **jkw))
    else:
        step = jax.jit(lambda p, tok, c, pos, nv: j_decode_step(p, tok, c, pos, cfg,
                                                                policy=jpol, nvalid=nv, **jkw))
    jc = j_make_cache(cfg, B, CAP, cache_cfg=jcc)
    tc = make_cache(tcfg, B, CAP, cache_cfg=tcc)
    rng = np.random.default_rng(chunk)
    pos = np.array([0, 2, -1], np.int32)
    for _ in range(5):
        tok = rng.integers(0, cfg.vocab_size, (B, chunk)).astype(np.int32)
        nv = np.array([chunk, max(chunk - 1, 1), 0], np.int32)
        lj, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(pos), jnp.asarray(nv))
        t_tok = torch.from_numpy(tok if chunk > 1 else tok[:, 0])
        lt, tc = decode_step(tp, t_tok, tc, torch.from_numpy(pos), tcfg, policy=tpol,
                             nvalid=torch.from_numpy(nv) if chunk > 1 else None, **tkw)
        lt, lj = lt.numpy()[:2], np.asarray(lj)[:2]
        if scheme == "fp16" or not BF16_DOT:
            assert np.abs(lt - lj).max() <= LOGIT_TOL * np.abs(lj).max()
            assert (lt.argmax(-1) == lj.argmax(-1)).all()
        else:
            np.testing.assert_array_equal(lt.view(np.int32), lj.view(np.int32))
        pos = pos + np.where(pos >= 0, nv, 0)
    for a, b in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        a = np.asarray(a)
        if not paged:
            a, b = a[:, :2], b[:, :2]
        if a.dtype == jnp.bfloat16:
            np.testing.assert_allclose(b.float().numpy(), a.astype(np.float32),
                                       rtol=BF16_REL, atol=BF16_ATOL)
        elif BF16_DOT:
            np.testing.assert_array_equal(a.view(np.uint8),
                                          b.contiguous().view(torch.uint8).numpy())
        else:
            assert (a.view(np.uint8) != b.contiguous().view(torch.uint8).numpy()).mean() \
                <= POOL_FLIPS


def workload():
    """Four requests on two slots; the last arrives with the first one's
    first page (8 tokens) as its prompt prefix."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, int(n)).astype(np.int32) for n in (13, 9, 17, 11)]
    prompts[3][:PAGE] = prompts[0][:PAGE]
    return prompts, [6, 5, 4, 6]


def serve(eng, prompts, max_tokens):
    hs = [eng.submit(p, m) for p, m in zip(prompts, max_tokens)]
    eng.run()
    return [list(h.tokens) for h in hs], eng.stats()


def reference_logits(jeng, cfg, chunk, prompt, tokens):
    """The reference's logits after ``prompt`` and the generated
    ``tokens``, fed as its engine feeds a request, in slot 0 of two (slot 1
    idle) through its jitted step: the prompt in chunks of ``chunk`` from
    position 0, then one token a step."""
    B, jcc = 2, jeng.cache_cfg
    kw = {}
    if jcc.paged:
        kw = dict(block_tables=jnp.arange(B * jcc.max_pages_per_seq,
                                          dtype=jnp.int32).reshape(B, -1))
    step = jax.jit(lambda p, tok, c, pos, nv: j_decode_step(
        p, tok, c, pos, cfg, policy=jeng.rcfg.quant, cache_cfg=jcc, nvalid=nv, **kw))
    step1 = jax.jit(lambda p, tok, c, pos: j_decode_step(
        p, tok, c, pos, cfg, policy=jeng.rcfg.quant, cache_cfg=jcc, **kw))
    cache = j_make_cache(cfg, B, CAP, cache_cfg=jcc)
    feeds = [prompt[i:i + chunk] for i in range(0, len(prompt), chunk)]
    feeds += [[t] for t in tokens]
    pos = 0
    for f in feeds:
        tok = np.zeros((B, chunk), np.int32)
        tok[0, :len(f)] = f
        ps = jnp.asarray([pos, -1], jnp.int32)
        if len(f) == 1:
            lg, cache = step1(jeng.params, jnp.asarray(tok[:, 0]), cache, ps)
        else:
            lg, cache = step(jeng.params, jnp.asarray(tok), cache, ps,
                             jnp.asarray([len(f), 0], jnp.int32))
        pos += len(f)
    return np.asarray(lg)[0]


def check_streams(got, want, prompts, jeng, cfg, chunk, label):
    """Each port stream equals the reference's, or first differs at a
    token where the reference's greedy choice was an exact tie: the two
    candidates' logits after the prompt and the stream so far equal
    (`reference_logits`; the reference takes the lower token). Without the
    bf16 dot order the two may be a near-tie, within LOGIT_TOL of the
    largest |logit|."""
    for prompt, g, w in zip(prompts, got, want):
        assert len(g) == len(w), label
        t = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if t is None:
            continue
        lg = reference_logits(jeng, cfg, chunk, prompt, w[:t])
        gap = abs(float(lg[w[t]]) - float(lg[g[t]]))
        limit = 0.0 if BF16_DOT else LOGIT_TOL * np.abs(lg).max()
        assert gap <= limit, (f"{label}: token {t} differs where the reference's logits are "
                              f"{gap} apart")


# the JAX (matmul, attention) lowerings each port tier reproduces, by cache
# kind: AMS pages round alike on both attention lowerings; K1 / K1b round
# the experts' g * u to bf16 as the Pallas call does (the fused_ref tier
# feeds it unrounded, `moe.expert_ffn`)
JAX_IMPLS = {("fused_ref", "paged_ams"): ("fused_ref", "ref"),
             ("kernel", "paged_ams"): ("pallas_interpret", "ref"),
             ("fused_ref", "paged_bf16"): ("fused_ref", "ref"),
             ("kernel", "paged_bf16"): ("fused_ref", "pallas_interpret"),
             ("fused_ref", "contiguous"): ("fused_ref", "ref"),
             ("kernel", "contiguous"): ("pallas_interpret", "pallas_interpret")}


@pytest.mark.parametrize("arch,scheme,kind,chunk", STREAM_CASES)
def test_engine_streams_match_reference(arch, scheme, kind, chunk):
    """The port's engine, impl pairs (fused_ref, ref) and (kernel, kernel),
    against the JAX engine's greedy streams (`check_streams`), tick
    accounting and cost keys
    (fused_ref matmuls, the attention lowering the port's impl reproduces:
    AMS pages round alike on both lowerings, bf16 pages and the contiguous
    cache need the reference's Pallas template in interpret mode). The
    shared prefix hits the prefix cache on the paged paths."""
    cfg, _ = configs(arch)
    npar = numpy_params(cfg)
    prompts, max_tokens = workload()
    want = {}
    for jimpl, jattn in sorted({JAX_IMPLS[i, kind] for i in ("fused_ref", "kernel")}):
        jeng = JServeEngine(JEngineConfig(
            arch=arch, reduced=True, scheme=scheme, impl=jimpl, slots=2, capacity=CAP,
            prefill_chunk=chunk, cache=JCacheConfig(kind=kind, page_size=PAGE, impl=jattn)),
            params=jax.tree.map(jnp.asarray, npar))
        want[jimpl, jattn] = (*serve(jeng, prompts, max_tokens), jeng)
    for impl, attn in (("fused_ref", "ref"), ("kernel", "kernel")):
        eng = ServeEngine(EngineConfig(
            arch=arch, reduced=True, scheme=scheme, impl=impl, slots=2, capacity=CAP,
            prefill_chunk=chunk, device="cpu",
            cache=CacheConfig(kind=kind, page_size=PAGE, impl=attn)),
            params=params_from_numpy(npar))
        got, st = serve(eng, prompts, max_tokens)
        ref, jst, jeng = want[JAX_IMPLS[impl, kind]]
        check_streams(got, ref, prompts, jeng, cfg, chunk,
                      f"{arch} {scheme}/{kind} {impl}/{attn} C={chunk}")
        for key in ("ticks", "tokens_generated", "ttft_ticks_p50", "latency_ticks_p50",
                    "kv_bytes_per_token", "floor_hbm_bytes", "floor_flops"):
            assert st[key] == jst[key], key
        if kind != "contiguous":
            assert st["prefix_hit_pages"] == jst["prefix_hit_pages"] >= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_seq_matches_reference(arch):
    """`forward_seq` over two 12-token prompts at three layers, FP4.25
    weights on the kernel tier against the jitted reference with
    ``pallas_interpret``: logits within FWD_LOGIT_TOL of the largest
    (LOGIT_TOL without the bf16 dot order), equal
    argmax at every position, the summed load-balance loss bit-equal, the
    cache's K / V within BF16_REL."""
    cfg, tcfg = configs(arch, layers=3)
    jp, jpol, tp, tpol = served(numpy_params(cfg), "fp4.25-e2m2", "pallas_interpret", "kernel")
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jaux, jcache = jax.jit(lambda p, t: j_forward_seq(p, t, cfg, policy=jpol, remat=False,
                                                          want_cache=True))(jp, jnp.asarray(tok))
    tl, taux, tcache = forward_seq(tp, torch.from_numpy(tok), tcfg, policy=tpol,
                                   want_cache=True)
    jl = np.asarray(jl)
    tol = FWD_LOGIT_TOL if BF16_DOT else LOGIT_TOL
    assert np.abs(tl.numpy() - jl).max() <= tol * np.abs(jl).max()
    assert (tl.numpy().argmax(-1) == jl.argmax(-1)).all()
    assert taux.dtype == torch.float32 and float(taux) > 0
    np.testing.assert_array_equal(taux.numpy().reshape(-1).view(np.uint8),
                                  np.asarray(jaux).reshape(-1).view(np.uint8))
    for a, b in zip(jax.tree.leaves(jcache), tree_leaves(tcache)):
        a, b = np.asarray(a.astype(jnp.float32)), b.float().numpy()
        assert a.shape == b.shape and np.abs(a - b).max() <= BF16_REL * np.abs(a).max()


@pytest.mark.parametrize("arch,scheme", [(SCOUT, "fp4.25-e2m2"), (DBRX, "fp16")])
def test_init_serving_params_equals_prepared_init(arch, scheme):
    """`init_serving_params` (the experts drawn and quantized one at a
    time) equals ``prepare_params(init_params(seed, cfg), quant)`` leaf for
    leaf, at three layers: packed expert planes stacked [G, E, ...], the
    router bf16 and unquantized."""
    _, tcfg = configs(arch, layers=3)
    quant = (None if scheme == "fp16" else
             QuantPolicy(scheme=scheme, impl="kernel", min_elements=1 << 10))
    got = init_serving_params(tcfg, quant, 5, "cpu")
    want = prepare_params(init_params(5, tcfg), quant)

    def walk(a, b, path=""):
        assert isinstance(a, dict) == isinstance(b, dict), path
        if isinstance(a, dict):
            assert list(a) == list(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), path

    walk(got, want)
    moe = got["layers"]["sub0"]["moe"]
    assert moe["router"]["w"].dtype == torch.bfloat16
    assert moe["router"]["w"].shape == (3, tcfg.d_model, tcfg.num_experts)
    lead = moe["experts"]["w_down"]["hi" if quant else "w"].shape[:2]
    assert lead == (3, tcfg.num_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_from_a_seed_serves(arch):
    """`ServeEngine` draws its own MoE weights from the seed and serves the
    ragged and one-token steps on the kernel tier over AMS pages; the
    signature names the arch."""
    eng = ServeEngine(EngineConfig(arch=arch, reduced=True, scheme="fp4.25-e2m2",
                                   impl="kernel", slots=2, capacity=CAP, prefill_chunk=4,
                                   device="cpu", seed=2,
                                   cache=CacheConfig(kind="paged_ams", page_size=PAGE,
                                                     impl="kernel")))
    prompts, max_tokens = workload()
    got, st = serve(eng, prompts, max_tokens)
    assert [len(g) for g in got] == max_tokens and st["prefix_hit_pages"] >= 1
    assert eng.signature["arch"] == arch


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_features_take_moe_layers(arch):
    """Sampling, preemption with its spill, n-gram and self-drafter
    speculation and the self drafter's `forward_seq` take MoE layers
    without a special case: on the kernel tier over AMS pages (chunk 4),
    greedy speculative streams equal plain decoding's, a request
    preempted mid-prefill and mid-decode resumes to its uninterrupted
    stream, and a seeded sampled request replays its stream."""
    from repro_torch.launch.sampling import SamplingParams

    def engine(**kw):
        return ServeEngine(EngineConfig(
            arch=arch, reduced=True, scheme="fp4.25-e2m2", impl="kernel", slots=2,
            capacity=CAP, prefill_chunk=4, device="cpu", seed=4,
            cache=CacheConfig(kind="paged_ams", page_size=PAGE, impl="kernel"), **kw))

    prompts, max_tokens = workload()
    plain, _ = serve(engine(), prompts, max_tokens)
    for drafter in ("ngram", "self", "self-full"):
        got, st = serve(engine(speculate_k=2, drafter=drafter), prompts, max_tokens)
        assert got == plain, drafter
    prompt = prompts[0]
    want = engine().submit(prompt, 8).result()
    for before in (2, 6):
        eng = engine()
        h = eng.submit(prompt, 8)
        for _ in range(before):
            eng.step()
        eng.preempt(h.request.slot)
        assert h.status == "preempted" and h.request.spill is not None
        assert h.result() == want and eng.stats()["resumes"] == 1
    sp = SamplingParams(temperature=0.8, top_k=40, top_p=0.9, seed=9)
    runs = [engine().submit(prompt, 8, sampling=sp).result() for _ in range(2)]
    assert runs[0] == runs[1] and len(runs[0]) == 8

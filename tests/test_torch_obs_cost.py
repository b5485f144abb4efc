"""Port parity of the roofline cost accounting (`repro_torch.obs.cost`,
`repro_torch.analysis.roofline.param_count`) against the JAX package's
`repro.obs.cost` on the CPU.

The floors, the cost models' fields, the engine's ``stats()`` cost keys and
`attribution` are integer sums and analytic floats, so they are compared
exactly; only the time floor differs, by design: the port divides by the
H100's peaks (3.35 TB/s, 989 TFLOP/s bf16), the reference by its TPU's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.analysis.roofline import param_count as j_param_count  # noqa: E402
from repro.cache import CacheConfig as JCacheConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.formats import SCHEMES as J_SCHEMES  # noqa: E402
from repro.launch.config import EngineConfig as JEngineConfig  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.obs import cost as jcost  # noqa: E402
from repro_torch.analysis.roofline import param_count  # noqa: E402
from repro_torch.cache import CacheConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.formats import get_scheme  # noqa: E402
from repro_torch.launch.config import EngineConfig  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.obs import cost  # noqa: E402

PAGE, CAP = 8, 48
ARCHS = ["qwen2-7b", "minicpm3-4b", "dbrx-132b", "falcon-mamba-7b", "recurrentgemma-9b"]


@pytest.mark.parametrize("scheme", sorted(J_SCHEMES))
def test_kv_floors_equal_jax(scheme):
    """The format and paper floors per K or V vector, over every scheme and
    head dims from 8 to 288 (odd ones included), and K+V over kv heads."""
    for hd in (8, 33, 64, 96, 128, 288):
        a = cost.kv_vector_bytes_floor(hd, get_scheme(scheme))
        assert a == jcost.kv_vector_bytes_floor(hd, J_SCHEMES[scheme])
        b = cost.kv_vector_bytes_ideal(hd, get_scheme(scheme))
        assert b == jcost.kv_vector_bytes_ideal(hd, J_SCHEMES[scheme])
        for kv in (1, 4, 8):
            assert 2 * kv * a == 2 * kv * jcost.kv_vector_bytes_floor(hd, J_SCHEMES[scheme])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_equals_jax(arch):
    for reduced in (False, True):
        cfg, jcfg = get_config(arch), j_get_config(arch)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        assert param_count(cfg) == j_param_count(jcfg)


@pytest.mark.parametrize("arch,scheme", [("qwen2-7b", "fp5.33-e2m3"), ("qwen2-7b", "fp16"),
                                         ("qwen2-7b", "fp4.25-e2m2"),
                                         ("minicpm3-4b", "fp5.33-e2m3"),
                                         ("falcon-mamba-7b", "fp5.33-e2m3"),
                                         ("falcon-mamba-7b", "fp16"),
                                         ("recurrentgemma-9b", "fp5.33-e2m3"),
                                         ("recurrentgemma-9b", "fp16")])
@pytest.mark.parametrize("kind", [None, "paged_bf16", "paged_ams"])
def test_build_cost_model_equals_jax(arch, scheme, kind):
    """Every field of the cost model (weights, FLOPs, KV floors, the bf16
    baseline and the ref gather's dequant term), full width and reduced."""
    for reduced in (False, True):
        cfg, jcfg = get_config(arch), j_get_config(arch)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        ccfg = None if kind is None else CacheConfig(kind=kind)
        jccfg = None if kind is None else JCacheConfig(kind=kind)
        got = cost.build_cost_model(cfg, scheme, ccfg, signature={"a": 1})
        want = jcost.build_cost_model(jcfg, scheme, jccfg, signature={"a": 1})
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for i, n in ((0, 1), (37, 1), (5, 16)):
            for ck in ("contiguous", "paged_ams"):
                for impl in ("ref", "kernel"):
                    kw = dict(cache_kind=ck, impl=impl, capacity=CAP, page_size=PAGE,
                              max_pages=6)
                    jkw = dict(kw, impl="ref" if impl == "ref" else "pallas")
                    assert got.achieved_kv_bytes(i, n, **kw) == want.achieved_kv_bytes(i, n,
                                                                                      **jkw)
            assert got.tick_floor_bytes(n, i) == want.tick_floor_bytes(n, i)
            assert got.tick_floor_flops(n, i) == want.tick_floor_flops(n, i)


def test_step_time_floor_uses_h100_peaks():
    """The time floor divides by one H100 SXM's published peaks, not the
    reference's TPU figures; at tp and kv shards other than 1 the model is
    per device, every field as the reference's, and a kv-head count the
    shards do not divide is refused as the reference refuses it."""
    from repro_torch.analysis import roofline
    assert (roofline.HBM_BW, roofline.PEAK_FLOPS) == (3.35e12, 989e12)
    cm = cost.build_cost_model(get_config("qwen2-7b"), "fp5.33-e2m3",
                               CacheConfig(kind="paged_ams"))
    jcm = jcost.build_cost_model(j_get_config("qwen2-7b"), "fp5.33-e2m3",
                                 JCacheConfig(kind="paged_ams"))
    for fed, reads in ((8, 2400), (128, 40000), (1, 1)):
        want = max(cm.tick_floor_bytes(fed, reads) / 3.35e12,
                   cm.tick_floor_flops(fed, reads) / 989e12)
        assert cm.step_time_floor_s(fed, reads) == want
        assert cm.step_time_floor_s(fed, reads) < jcm.step_time_floor_s(fed, reads)
    for tp, shards in ((2, 1), (2, 2), (4, 4)):
        got = cost.build_cost_model(get_config("qwen2-7b"), "fp16", CacheConfig(kind="paged_ams"),
                                    tp=tp, kv_shards=shards)
        want = jcost.build_cost_model(j_get_config("qwen2-7b"), "fp16",
                                      JCacheConfig(kind="paged_ams"), tp=tp, kv_shards=shards)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError, match="kv_shards"):
        cost.build_cost_model(get_config("qwen2-7b"), "fp16", kv_shards=3)


# ------------------------------------------------------------------ engines
@pytest.fixture(scope="module")
def jax_params():
    return j_init_params(jax.random.PRNGKey(0), j_get_config("qwen2-7b").reduced())


@pytest.fixture(scope="module")
def np_params(jax_params):
    return jax.tree.map(np.asarray, jax_params)


COST_KEYS = ("kv_bytes_per_token", "kv_bytes_per_token_floor", "kv_bytes_per_token_ideal",
             "kv_floor_ratio", "kv_vs_ideal_floor", "kv_achieved_vs_floor", "floor_hbm_bytes",
             "floor_flops")


@pytest.mark.parametrize("kind,impl", [("paged_ams", "ref"), ("paged_ams", "kernel"),
                                       ("contiguous", "ref")])
def test_engine_cost_keys_equal_jax(kind, impl, np_params, jax_params):
    """The same requests (a shared prefix on the paged cache, chunked
    prefill, decode) through the port's engine and a freshly run JAX
    engine: the cost keys of ``stats()``, every key of `attribution` but
    the signature (whose shared keys but the impl's name agree) and each request's floor and
    achieved KV bytes are equal. The port's ``kernel`` attention is
    counted as the reference's fused template (causal whole pages, no
    dequant term): against JAX's ``pallas`` accounting branch, whose
    engine is run with ``pallas_interpret`` here."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (19, 7, 13)]
    prompts[2][:PAGE] = prompts[0][:PAGE]
    port = ServeEngine(EngineConfig(
        arch="qwen2-7b", reduced=True, scheme="fp5.33-e2m3", impl="fused_ref", slots=2,
        capacity=CAP, prefill_chunk=4, device="cpu",
        cache=CacheConfig(kind=kind, page_size=PAGE, impl=impl)),
        params=params_from_numpy(np_params))
    jeng = JServeEngine(JEngineConfig(
        arch="qwen2-7b", reduced=True, scheme="fp5.33-e2m3", impl="fused_ref", slots=2,
        capacity=CAP, prefill_chunk=4,
        cache=JCacheConfig(kind=kind, page_size=PAGE,
                           impl="ref" if impl == "ref" else "pallas_interpret")),
        params=jax_params)
    hp = [port.submit(p, 5) for p in prompts]
    hj = [jeng.submit(p, 5) for p in prompts]
    port.run()
    jeng.run()
    assert port.tick == jeng.tick
    sp, sj = port.stats(), jeng.stats()
    assert {k: sp[k] for k in COST_KEYS} == {k: sj[k] for k in COST_KEYS}
    assert sp["floor_hbm_bytes"] > 0 and sp["kv_achieved_vs_floor"] > 0
    ap, aj = cost.attribution(port), jcost.attribution(jeng)
    sig_p, sig_j = ap.pop("signature"), aj.pop("signature")
    assert ap == aj
    shared = (sig_p.keys() & sig_j.keys()) - {"impl"}      # the lowerings' own names
    assert {k: sig_p[k] for k in shared} == {k: sig_j[k] for k in shared}
    assert [(h.kv_floor_bytes, h.kv_achieved_bytes, h.kv_vs_floor) for h in hp] == \
        [(h.kv_floor_bytes, h.kv_achieved_bytes, h.kv_vs_floor) for h in hj]


def test_attribution_profile_needs_the_card(np_params):
    """The profiled replay stands in for the reference's compiled-HLO cost:
    an engine on CPU tensors has no graph to replay, and refuses."""
    eng = ServeEngine(EngineConfig(arch="qwen2-7b", reduced=True, slots=1, capacity=CAP,
                                   device="cpu", impl="kernel",
                                   cache=CacheConfig(kind="paged_ams", page_size=PAGE,
                                                     impl="kernel")),
                      params=params_from_numpy(np_params))
    eng.submit(np.arange(1, 6, dtype=np.int32), 2).result()
    assert cost.attribution(eng)["served_ticks"] == eng.stats()["ticks"]
    with pytest.raises(RuntimeError, match="CPU tensors"):
        cost.attribution(eng, profile=True)


def test_mamba_engine_cost_keys_equal_jax():
    """Reduced falcon-mamba-7b (FP5.33, the one-token step over its state
    caches) through both engines: the cost keys of ``stats()``, every key
    of `attribution` but the signature, and each request's floor and
    achieved KV bytes are equal. The reference counts KV for Mamba from
    num_kv_heads x head_dim, though Mamba keeps none, and so does the port."""
    jp = j_init_params(jax.random.PRNGKey(0), j_get_config("falcon-mamba-7b").reduced())
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (9, 5, 12)]
    port = ServeEngine(EngineConfig(arch="falcon-mamba-7b", reduced=True, scheme="fp5.33-e2m3",
                                    impl="kernel", slots=2, capacity=32, device="cpu"),
                       params=params_from_numpy(jax.tree.map(np.asarray, jp)))
    jeng = JServeEngine(JEngineConfig(arch="falcon-mamba-7b", reduced=True,
                                      scheme="fp5.33-e2m3", impl="pallas_interpret", slots=2,
                                      capacity=32), params=jp)
    hp = [port.submit(p, 4) for p in prompts]
    hj = [jeng.submit(p, 4) for p in prompts]
    port.run()
    jeng.run()
    assert port.tick == jeng.tick
    sp, sj = port.stats(), jeng.stats()
    assert {k: sp[k] for k in COST_KEYS} == {k: sj[k] for k in COST_KEYS}
    assert sp["kv_bytes_per_token"] > 0
    ap, aj = cost.attribution(port), jcost.attribution(jeng)
    ap.pop("signature"), aj.pop("signature")
    assert ap == aj
    assert [(h.kv_floor_bytes, h.kv_achieved_bytes) for h in hp] == \
        [(h.kv_floor_bytes, h.kv_achieved_bytes) for h in hj]


@pytest.mark.parametrize("arch", ["llama4-scout-17b-16e", "dbrx-132b"])
@pytest.mark.parametrize("scheme,kind", [("fp4.25-e2m2", "paged_ams"), ("fp16", "paged_bf16"),
                                         ("fp4.25-e2m2", None)])
def test_moe_cost_model_keeps_the_reference_formula(arch, scheme, kind):
    """MoE cost models equal the reference's, full width and reduced. The
    weight floor reads every expert (``total`` parameters: `moe_dense`
    reads all of them each tick); the FLOP floor keeps the reference's
    ``2 x active`` (top-k experts only), although `moe_dense` computes
    every expert on every token (ROADMAP queue 3)."""
    for reduced in (False, True):
        cfg, jcfg = get_config(arch), j_get_config(arch)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        ccfg = None if kind is None else CacheConfig(kind=kind)
        jccfg = None if kind is None else JCacheConfig(kind=kind)
        got = cost.build_cost_model(cfg, scheme, ccfg, signature={"a": 1})
        want = jcost.build_cost_model(jcfg, scheme, jccfg, signature={"a": 1})
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        pc = param_count(cfg)
        assert got.flops_per_token == 2.0 * pc["active"] < 2.0 * pc["total"]
        wbits = 16.0 if scheme == "fp16" else get_scheme(scheme).effective_bits
        assert got.weight_bytes == pc["total"] * wbits / 8.0

"""Port parity of preemption with host spill: the page spill helpers
(`cache.extract_pages`, `restore_pages`, `host_bytes`), the engine's
priority policy, forced preempt / resume, shared prefix pages and the host
spill tier, against the JAX package on the CPU with the same numpy-made
weights and pools. Everything here is exact: pool bytes, counts, streams.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cache import CacheConfig as JCacheConfig  # noqa: E402
from repro.cache import extract_pages as j_extract_pages  # noqa: E402
from repro.cache import host_bytes as j_host_bytes  # noqa: E402
from repro.cache import restore_pages as j_restore_pages  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch.config import EngineConfig as JEngineConfig  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.launch.sampling import SamplingParams as JSamplingParams  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_cache as j_make_cache  # noqa: E402
from repro_torch.cache import CacheConfig, extract_pages, host_bytes, restore_pages  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.launch.config import EngineConfig  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402
from repro_torch.launch.sampling import SamplingParams  # noqa: E402
from repro_torch.models import make_cache  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.obs import ObsConfig  # noqa: E402

SCHEME = "fp5.33-e2m3"
SEEDED = dict(temperature=0.8, top_k=16, seed=42)


@pytest.fixture(scope="module")
def jax_params():
    return j_init_params(jax.random.PRNGKey(0), get_config("qwen2-7b").reduced())


@pytest.fixture(scope="module")
def t_params(jax_params):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params))


def cache_kw(kind="paged_ams", spill=32, page=8):
    return dict(kind=kind, page_size=page, host_spill_pages=spill)


def t_engine(t_params, chunk=1, slots=2, capacity=48, obs=None, **ckw):
    return ServeEngine(EngineConfig(
        arch="qwen2-7b", reduced=True, scheme=SCHEME, impl="kernel", slots=slots,
        capacity=capacity, prefill_chunk=chunk, device="cpu", obs=obs or ObsConfig(),
        cache=CacheConfig(impl="kernel", **cache_kw(**ckw))), params=t_params)


def j_engine(jax_params, chunk=1, slots=2, capacity=48, **ckw):
    return JServeEngine(JEngineConfig(
        arch="qwen2-7b", reduced=True, scheme=SCHEME, impl="fused_ref", slots=slots,
        capacity=capacity, prefill_chunk=chunk, cache=JCacheConfig(**cache_kw(**ckw))),
        params=jax_params)


def as_bytes(t):
    return t.contiguous().view(torch.uint8).numpy() if torch.is_tensor(t) else \
        np.ascontiguousarray(np.asarray(t)).view(np.uint8)


# ------------------------------------------------------- page spill helpers
@pytest.mark.parametrize("kind", ["paged_ams", "paged_bf16"])
def test_extract_and_restore_pages_equal_the_reference(kind):
    """On an engine cache (stacked layers) filled with the same random bytes
    on both sides: extract_pages gives JAX's bytes and layout, host_bytes
    its count, and restore_pages into other pages gives JAX's pool, writing
    in place (every plane keeps its storage)."""
    cfg, tcfg = get_config("qwen2-7b").reduced(), t_get_config("qwen2-7b").reduced()
    jcc = JCacheConfig(kind=kind, page_size=8).sized(capacity=32, slots=3)
    tcc = CacheConfig(kind=kind, page_size=8).sized(capacity=32, slots=3)
    jc, tc = j_make_cache(cfg, 3, 32, cache_cfg=jcc), make_cache(tcfg, cache_cfg=tcc)
    rng = np.random.default_rng(1)
    filled = []
    for jl, tl in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        if tl.is_floating_point():         # finite values (bf16 pages, AMS scales)
            vals = rng.normal(size=tl.shape).astype(np.float32)
            tl.copy_(torch.from_numpy(vals))
            filled.append(jnp.asarray(vals).astype(jl.dtype))
        else:                              # packed code planes: any bytes
            raw = rng.integers(0, 256, tl.numel() * tl.element_size(), dtype=np.uint8)
            tl.view(torch.uint8).view(-1).copy_(torch.from_numpy(raw))
            filled.append(jnp.asarray(raw.view(np.asarray(jl).dtype).reshape(jl.shape)))
    jc = jax.tree.unflatten(jax.tree.structure(jc), filled)
    ids, dst = [4, 1, 7], [2, 9, 0]
    jh, th = j_extract_pages(jc, ids), extract_pages(tc, ids)
    jl, tl = jax.tree.leaves(jh), tree_leaves(th)
    assert len(jl) == len(tl) == (2 if kind == "paged_bf16" else 6)
    for a, b in zip(jl, tl):
        assert a.shape == tuple(b.shape) and b.device.type == "cpu"
        np.testing.assert_array_equal(as_bytes(a), as_bytes(b))
    assert host_bytes(th) == j_host_bytes(jh)
    ptrs = [t.data_ptr() for t in tree_leaves(tc)]
    restore_pages(tc, dst, th)
    jc = j_restore_pages(jc, dst, jh)
    assert [t.data_ptr() for t in tree_leaves(tc)] == ptrs
    for a, b in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        np.testing.assert_array_equal(as_bytes(a), as_bytes(b))


# ---------------------------------------------------- forced preempt/resume
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
def test_preempt_resume_streams_equal_uninterrupted_and_jax(chunk, sampled, jax_params,
                                                            t_params):
    """A preemption mid-prefill and one mid-decode: the resumed stream
    equals the uninterrupted one, which equals the JAX engine's, and so
    does the JAX engine's own preempt-resume run."""
    prompt = (np.arange(1, 14, dtype=np.int32) * 3) % 200 + 1
    tsp = SamplingParams(**SEEDED) if sampled else None
    jsp = JSamplingParams(**SEEDED) if sampled else None
    want = t_engine(t_params, chunk).submit(prompt, 10, sampling=tsp).result()
    assert j_engine(jax_params, chunk).submit(prompt, 10, sampling=jsp).result() == want
    prefill_ticks = -(-len(prompt) // chunk)
    for before in (2, prefill_ticks + 3):
        runs = []
        for eng, sp in ((t_engine(t_params, chunk), tsp), (j_engine(jax_params, chunk), jsp)):
            h = eng.submit(prompt, 10, sampling=sp)
            for _ in range(before):
                eng.step()
            eng.preempt(h.request.slot)
            assert h.status == "preempted" and h.request.spill is not None
            runs.append((h.result(), eng.stats()["preemptions"], eng.stats()["resumes"],
                         eng.stats()["spill_pages"], eng.stats()["spill_bytes"]))
        assert runs[0] == runs[1] and runs[0][0] == want and runs[0][1:3] == (1, 1), before


def test_spilled_ams_planes_come_back_byte_equal(t_params):
    """A spill on a page boundary is restored byte-equal into fresh pages,
    which later inserts leave as they are."""
    eng = t_engine(t_params)
    h = eng.submit((np.arange(1, 20, dtype=np.int32) * 7) % 300 + 1, 8)
    for _ in range(8):
        eng.step()
    req = h.request
    eng.preempt(req.slot)
    sp = req.spill
    assert sp.fed == 8 and sp.n_pages == 1 and sp.nbytes == host_bytes(sp.content) > 0
    spilled = [t.clone() for t in tree_leaves(sp.content)]
    other = eng.submit(np.arange(50, 71, dtype=np.int32), 4)
    assert h.result() and other.result()
    restored = extract_pages(eng.cache, req.pages[sp.n_keep:sp.n_keep + sp.n_pages])
    for a, b in zip(spilled, tree_leaves(restored)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


# ------------------------------------------------------------ the policy
def overload(eng, sp_cls, priority):
    """The reference benchmark's overload row at test size: three batch
    requests saturate two slots from tick 0, five short ones arrive on top
    at the given priority."""
    rng = np.random.default_rng(0)
    batch = [(0, rng.integers(0, 512, 10), 24) for _ in range(3)]
    inter = [(int(t), rng.integers(0, 512, 4), 4)
             for t in np.cumsum(rng.geometric(0.12, 5)) + 2]
    work = sorted([(t, p, m, 0) for t, p, m in batch]
                  + [(t, p, m, priority) for t, p, m in inter], key=lambda w: w[0])
    hs = []
    while work or eng.has_work:
        while work and work[0][0] <= eng.tick:
            t, p, m, pri = work.pop(0)
            hs.append(eng.submit(p, m, priority=pri, sampling=sp_cls(seed=0)))
        eng.step()
    return [list(h.tokens) for h in hs], eng.stats()


def test_priority_overload_matches_jax_and_head_of_line(jax_params, t_params):
    """Preemptions, resumes, spilled pages and bytes equal the JAX engine's;
    the streams equal JAX's and the head-of-line run's (priority moves when
    a request runs, never what it emits)."""
    got, st = overload(t_engine(t_params, spill=64), SamplingParams, 5)
    want, jst = overload(j_engine(jax_params, spill=64), JSamplingParams, 5)
    hol, _ = overload(t_engine(t_params, spill=64), SamplingParams, 0)
    assert got == want == hol
    assert st["preemptions"] >= 1 and st["restored_pages"] >= 1
    for key in ("preemptions", "resumes", "spill_pages", "spill_bytes", "ticks",
                "ttft_ticks_p99"):
        assert st[key] == jst[key], key


def test_preemption_stats_without_obs(t_params):
    """The preemption stats are plain counters: with telemetry off the
    overload row reports the same preemptions, resumes, spills and restored
    pages as with it on."""
    keys = ("preemptions", "resumes", "spill_pages", "spill_bytes", "restored_pages")
    _, on = overload(t_engine(t_params, spill=64), SamplingParams, 5)
    _, off = overload(t_engine(t_params, spill=64, obs=ObsConfig(enabled=False)),
                      SamplingParams, 5)
    assert on["restored_pages"] >= 1
    assert {k: off[k] for k in keys} == {k: on[k] for k in keys}


def test_equal_priority_never_preempts(t_params):
    eng = t_engine(t_params)
    eng.submit(np.arange(1, 8, dtype=np.int32), 12)
    eng.submit(np.arange(2, 9, dtype=np.int32), 12)
    for _ in range(3):
        eng.step()
    h = eng.submit(np.arange(3, 10, dtype=np.int32), 4)
    eng.run()
    assert eng.preemptions == 0 and h.done


def test_shared_prefix_pages_survive_preemption(jax_params, t_params):
    """A victim sharing prefix pages with a live request keeps them pinned
    (no spill of them), and both streams equal the JAX engine's run of the
    same schedule."""
    sys_prompt = np.arange(200, 216, dtype=np.int32)            # two full pages
    a_p = np.concatenate([sys_prompt, np.arange(1, 6, dtype=np.int32)])
    b_p = np.concatenate([sys_prompt, np.arange(50, 54, dtype=np.int32)])
    outs = []
    for eng in (t_engine(t_params), j_engine(jax_params)):
        ha = eng.submit(a_p, 8)
        while ha.request.published < 2:
            eng.step()
        hb = eng.submit(b_p, 8)
        while hb.status == "queued":
            eng.step()
        assert hb.request.cached_len == 16
        shared = list(hb.request.pages[:2])
        eng.preempt(hb.request.slot)
        assert hb.request.pages == shared and hb.request.spill.n_keep == 2
        assert all(eng.alloc.refcount(p) >= 1 for p in shared)
        outs.append([ha.result(), hb.result()])
        eng.alloc.check_invariants()
        assert eng.stats()["cached_token_frac"] > 0
    assert outs[0] == outs[1]


def test_host_tier_serves_an_evicted_prefix(jax_params, t_params):
    """Prefix pages evicted under pressure spill to the host tier and come
    back on a later prefix match: the stream equals the first run's and the
    JAX engine's, with the same tier counts."""
    prompt = np.arange(300, 317, dtype=np.int32)
    res = []
    for eng in (t_engine(t_params, slots=1, capacity=32, spill=16),
                j_engine(jax_params, slots=1, capacity=32, spill=16)):
        first = eng.submit(prompt, 6).result()
        for j in range(3):
            eng.submit(np.arange(1 + 40 * j, 18 + 40 * j, dtype=np.int32), 6).result()
        h = eng.submit(prompt, 6)
        assert h.result() == first and h.request.cached_len >= 16
        eng.alloc.check_invariants()
        s = eng.alloc.stats()
        res.append((first, s["host_spill_pages_total"], s["host_restore_pages_total"]))
    assert res[0] == res[1] and res[0][1] >= 2 and res[0][2] >= 2

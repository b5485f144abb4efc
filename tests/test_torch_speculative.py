"""Port parity of speculative decoding: the n-gram drafter, the on-device
verify (`launch.speculative.verify_tokens`), the in-step rollback of pool
and contiguous caches (`cache.pool.paged_truncate`,
`models.attention.cache_truncate_chunk`) and speculative engine streams,
against the JAX package on the CPU with the same numpy-made inputs.

Exact everywhere: drafts, accepted counts, emitted tokens, done flags, pool
bytes and streams. The sampled verify draws from JAX's Gumbel noise, which
the port matches within one log ulp (`test_torch_sampling.py`); on these
seeded inputs every draw agrees.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cache import CacheConfig as JCacheConfig  # noqa: E402
from repro.cache import paged_truncate as j_paged_truncate  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch import sampling as JS  # noqa: E402
from repro.launch import speculative as JSP  # noqa: E402
from repro.launch.config import EngineConfig as JEngineConfig  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.attention import cache_truncate_chunk as j_cache_truncate_chunk  # noqa: E402
from repro_torch.cache import CacheConfig, make_gqa_page_pool, paged_truncate  # noqa: E402
from repro_torch.launch import sampling as S  # noqa: E402
from repro_torch.launch import speculative as SP  # noqa: E402
from repro_torch.launch.config import EngineConfig  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402
from repro_torch.models.attention import cache_truncate_chunk  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402

PAGE, CAP = 8, 64


# -------------------------------------------------------------- drafters
def test_ngram_drafter_matches_the_reference():
    rng = np.random.default_rng(0)
    hists = [np.tile(rng.integers(0, 9, 5), 4), rng.integers(0, 4, 30), rng.integers(0, 1000, 12),
             np.array([7], np.int32), np.array([3, 3], np.int32), np.arange(10)]
    for drafter in ((SP.NgramDrafter(), JSP.NgramDrafter()),
                    (SP.NgramDrafter(4, 2), JSP.NgramDrafter(4, 2))):
        for h in hists:
            for k in (1, 3, 6):
                np.testing.assert_array_equal(drafter[0].propose(h, k), drafter[1].propose(h, k))


def test_make_drafter_names():
    """Each name builds its drafter: the self drafters bind the given
    params' first layer or whole stack (and need params, config and
    capacity); EngineConfig checks a name without building it."""
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.models import init_params

    assert isinstance(SP.make_drafter("ngram"), SP.NgramDrafter)
    cfg = t_get_config("qwen2-7b").reduced()
    params = init_params(0, cfg)
    for name, layers in (("self", 1), ("self-full", cfg.num_layers)):
        d = SP.make_drafter(name, params=params, cfg=cfg, capacity=16)
        assert isinstance(d, SP.SelfDrafter) and d.draft_cfg.num_layers == layers
        assert tree_leaves(d.draft_params["layers"])[0].shape[0] == layers
        with pytest.raises(ValueError, match="params"):
            SP.make_drafter(name)
        assert EngineConfig(speculate_k=2, drafter=name).drafter == name
    with pytest.raises(ValueError, match="unknown drafter"):
        SP.make_drafter("oracle")
    with pytest.raises(ValueError, match="unknown drafter"):
        EngineConfig(speculate_k=2, drafter="oracle")
    with pytest.raises(ValueError, match="speculate_k"):
        EngineConfig(speculate_k=-1)


# ---------------------------------------------------------------- verify
def verify_case(rng, B, K, V, sampled):
    """Seeded logits and a fed chunk whose drafts follow each row's argmax
    for a while, then stray; stop ids and length caps land mid-round."""
    logits = (rng.normal(size=(B, K + 1, V)) * 2).astype(np.float32)
    ndraft = np.array([K, K, max(K - 1, 0), 0, K, 1][:B], np.int32)
    nvalid = ndraft + 1 + np.array([0, 2, 0, 3, 0, 0][:B], np.int32)   # some chunks longer
    C = int(nvalid.max()) + 1
    token = rng.integers(0, V, (B, C)).astype(np.int32)
    arg = logits.argmax(-1)
    for b in range(B):
        d0 = nvalid[b] - ndraft[b]
        agree = ndraft[b] if b == 0 else rng.integers(0, ndraft[b] + 1)   # row 0 accepts all
        for j in range(ndraft[b]):
            token[b, d0 + j] = arg[b, j] if j < agree else (arg[b, j] + 1) % V
    batch = S.slot_batch(B)
    for b in range(B):
        stops = (int(arg[b, 1]),) if b == 4 else ()
        sp = S.SamplingParams(temperature=(0.9 if sampled and b % 2 == 0 else 0.0),
                              top_k=(20 if b == 2 else 0), top_p=(0.9 if b == 4 else 1.0),
                              seed=b, stop_token_ids=stops)
        S.fill_slot(batch, b, sp, S.request_key(sp.seed, 50 + b), max_tokens=8 + b)
    batch["ngen"][:] = [5, 2, 3, 7, 2, 6][:B]        # rows 1 and 5 hit their length caps
    batch["max_tokens"][1], batch["max_tokens"][5] = 3, 8
    for name in ("ngen", "max_tokens"):
        batch["device"][name].copy_(torch.from_numpy(batch[name]))
    return logits, token, nvalid, ndraft, batch


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_verify_tokens_equals_the_reference(K, sampled):
    """Accepted counts, emitted tokens, emission lengths and done flags
    equal the reference's `verify_tokens` (its greedy-only branch, or the
    mixed one), stop-token and length-cap truncation mid-round included."""
    rng = np.random.default_rng(10 * K + sampled)
    for V in (64, 2048):
        logits, token, nvalid, ndraft, batch = verify_case(rng, 6, K, V, sampled)
        got = SP.verify_tokens(torch.from_numpy(logits), torch.from_numpy(token),
                               torch.from_numpy(nvalid), torch.from_numpy(ndraft), batch, K)
        want = JSP.verify_tokens(jnp.asarray(logits), jnp.asarray(token), jnp.asarray(nvalid),
                                 jnp.asarray(ndraft),
                                 {k: jnp.asarray(v) for k, v in batch.items() if k != "device"},
                                 K)
        for g, w, name in zip(got, want, ("out", "n_emit", "accepted", "done")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"V={V} {name}")
        done, n_emit, acc = got[3].numpy(), got[1].numpy(), got[2].numpy()
        assert done[1] and n_emit[1] == 1                   # the length cap ends row 1
        if not sampled:
            assert acc.max() >= 1


# -------------------------------------------------------------- truncate
def truncate_ticks():
    """(start, count, block_table) per call on 4 slots: a live slot, a slot
    rewinding 0, an idle slot whose stale block-table row names pages the
    live slots truncate, a rewind across a page boundary, and a call in
    which nothing is live."""
    bt = np.array([[3, 5, 7, 9], [2, 4, 6, 8], [10, 11, 12, 13], [3, 4, 5, 2]], np.int32)
    return [(np.array([3, 6, -1, 12], np.int32), np.array([2, 0, 3, 4], np.int32), bt),
            (np.array([7, 1, 9, -1], np.int32), np.array([4, 3, 0, 2], np.int32), bt),
            (np.array([-1, 5, 2, 0], np.int32), np.array([4, 0, 0, 0], np.int32), bt)]


@pytest.mark.parametrize("kind", ["paged_ams", "paged_bf16"])
def test_paged_truncate_equals_the_reference_and_moves_no_other_byte(kind):
    """Pool bytes after each call equal the reference's `paged_truncate`,
    and equal the old pool with only the live entries' rows zeroed; leaves
    with a stacked layer dim are truncated in every layer."""
    ccfg = CacheConfig(kind=kind, page_size=4, num_pages=14, max_pages_per_seq=4,
                       kv_scheme="fp4.25-e2m2")
    jcc = JCacheConfig(kind=kind, page_size=4, num_pages=14, max_pages_per_seq=4,
                       kv_scheme="fp4.25-e2m2")
    pool = make_gqa_page_pool(ccfg, 2, 16, lead=(2,))
    rng = np.random.default_rng(2)
    for leaf in tree_leaves(pool):
        leaf.copy_(torch.from_numpy(rng.integers(1, 100, leaf.shape)).to(leaf.dtype))
    for start, count, bt in truncate_ticks():
        old = [t.clone() for t in tree_leaves(pool)]
        paged_truncate(pool, torch.from_numpy(start), torch.from_numpy(count),
                       torch.from_numpy(bt), ccfg, 4)
        for a, b in zip(tree_leaves(pool), old):
            expect = b.clone()
            for s in range(4):
                for j in range(count[s] if start[s] >= 0 else 0):
                    p = start[s] + j
                    expect[:, bt[s, p // 4], p % 4] = 0
            assert torch.equal(a.view(torch.uint8), expect.view(torch.uint8))
        # the reference, one layer at a time, on the same old bytes
        for layer in range(2):
            jpool = jax.tree.map(
                lambda t: (jnp.asarray(t[layer].float().numpy()).astype(jnp.bfloat16)
                           if t.dtype == torch.bfloat16 else jnp.asarray(t[layer].numpy())),
                _tree(old, pool))
            jout = j_paged_truncate(jpool, jnp.asarray(start), jnp.asarray(count),
                                    jnp.asarray(bt), jcc, 4)
            for a, b in zip(jax.tree.leaves(jout), tree_leaves(pool)):
                np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                              b[layer].contiguous().view(torch.uint8).numpy())


def _tree(leaves, like):
    """``leaves`` in the dict structure of ``like``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return next(it)
    return build(like)


def test_cache_truncate_chunk_equals_the_reference():
    """Contiguous leaves [B, S, ...]: rows start .. start + count - 1 zeroed,
    rows past S dropped, count 0 and idle slots untouched, bf16 and the MLA
    stream's width alike."""
    rng = np.random.default_rng(0)
    start = np.array([2, 5, 8, -1], np.int32)
    count = np.array([3, 0, 3, 2], np.int32)              # slot 2 runs past S
    for shape in ((4, 10, 2, 4), (4, 10, 9)):
        x = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(j_cache_truncate_chunk(jnp.asarray(x), jnp.asarray(start),
                                                 jnp.asarray(count), 4))
        got = cache_truncate_chunk(torch.from_numpy(x.copy()), torch.from_numpy(start),
                                   torch.from_numpy(count), 4).numpy()
        np.testing.assert_array_equal(got, want)
        expect = x.copy()
        expect[0, 2:5] = 0
        expect[2, 8:10] = 0
        np.testing.assert_array_equal(got, expect)


# --------------------------------------------------------------- streams
@pytest.fixture(scope="module")
def jax_params():
    return j_init_params(jax.random.PRNGKey(0), get_config("qwen2-7b").reduced())


@pytest.fixture(scope="module")
def t_params(jax_params):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params))


def spec_prompts():
    base = np.array([5, 17, 99, 3, 42, 8], np.int32)
    return [np.tile(base, 3), np.tile(base[::-1], 2)[:11], np.tile(base + 1, 3)[:16]]


def t_serve(t_params, k, chunk, sampling=None, slots=2, kind="paged_ams"):
    eng = ServeEngine(EngineConfig(
        arch="qwen2-7b", reduced=True, scheme="fp5.33-e2m3", impl="kernel", slots=slots,
        capacity=CAP, prefill_chunk=chunk, speculate_k=k, device="cpu",
        cache=CacheConfig(kind=kind, page_size=PAGE, impl="kernel")), params=t_params)
    hs = [eng.submit(p, 20, sampling=sp) for p, sp in zip(spec_prompts(), sampling or [None] * 3)]
    eng.run()
    return [list(h.tokens) for h in hs], eng.stats()


def j_serve(jax_params, k, chunk, sampling=None):
    eng = JServeEngine(JEngineConfig(
        arch="qwen2-7b", reduced=True, scheme="fp5.33-e2m3", impl="fused_ref", slots=2,
        capacity=CAP, prefill_chunk=chunk, speculate_k=k,
        cache=JCacheConfig(kind="paged_ams", page_size=PAGE)), params=jax_params)
    hs = [eng.submit(p, 20, sampling=sp) for p, sp in zip(spec_prompts(), sampling or [None] * 3)]
    eng.run()
    return [list(h.tokens) for h in hs], eng.stats()


@pytest.mark.parametrize("k,chunk", [(2, 4), (4, 1)])
def test_speculative_greedy_streams_equal_plain_and_jax(k, chunk, jax_params, t_params):
    """n-gram drafts at k in {2, 4}, FP5.33 weights over AMS pages: greedy
    streams equal non-speculative decoding's and the JAX speculative
    engine's, with the same drafts proposed and accepted."""
    got, st = t_serve(t_params, k, chunk)
    plain, _ = t_serve(t_params, 0, chunk)
    want, jst = j_serve(jax_params, k, chunk)
    assert got == plain == want
    assert st["spec_proposed"] > 0 and st["spec_accepted"] > 0
    for key in ("spec_proposed", "spec_accepted", "ticks", "tokens_per_step", "accept_rate"):
        assert st[key] == jst[key], key


def test_seeded_speculative_streams_replay_and_match_jax(jax_params, t_params):
    """Sampled speculative streams equal the JAX engine's and replay across
    a restart, another slot count and another chunk."""
    mk = [dict(temperature=0.8, top_k=20, seed=2), dict(), dict(temperature=1.0, seed=9)]
    got, _ = t_serve(t_params, 2, 1, [S.SamplingParams(**m) for m in mk])
    want, _ = j_serve(jax_params, 2, 1, [JS.SamplingParams(**m) for m in mk])
    assert got == want
    assert t_serve(t_params, 2, 1, [S.SamplingParams(**m) for m in mk])[0] == got
    assert t_serve(t_params, 2, 4, [S.SamplingParams(**m) for m in mk], slots=3)[0] == got


def test_speculative_rollback_over_a_contiguous_cache(t_params):
    """The contiguous cache's rollback (`cache_truncate_chunk` in the step)
    keeps greedy streams equal to plain decoding's."""
    got, st = t_serve(t_params, 3, 1, kind="contiguous")
    assert got == t_serve(t_params, 0, 1, kind="contiguous")[0] and st["spec_proposed"] > 0

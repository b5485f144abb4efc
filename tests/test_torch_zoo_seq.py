"""Port parity of the rest of the dense model zoo, stepwise: per-step
logits with the embeds override (internvl2-1b, musicgen-medium), the
full-sequence forward `models.forward_seq` and its attention core,
against the JAX package on the CPU with the same numpy-made inputs
(`test_torch_self_drafter.py` holds the self drafters built on it).

The JAX side runs as its tests run it: the decode step and the sequence
forward compiled by XLA. Exact where the port copies the compiled step's
rounding (pool bytes, the sequence forward's cache); per-step
logits within one bf16 ulp of the largest logits, as
`test_torch_engine.py` holds them; the sequence forward's logits within
1e-3 of the largest logit (its f32 attention sums run in another order:
measured 7.4e-6 on these inputs).
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
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward_seq as j_forward_seq  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_cache as j_make_cache  # noqa: E402
from repro.models.common import quantize_params as j_quantize_params  # noqa: E402
from repro_torch.cache import CacheConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.policy import QuantPolicy  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch.engine import prepare_params  # noqa: E402
from repro_torch.models import decode_step, forward_seq, make_cache  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

SCHEME = "fp5.33-e2m3"
PAGE, CAP = 8, 48
SEQ_TOL = 1e-3                 # forward_seq logits: max |d| / max |logit|


@pytest.fixture(scope="module")
def weights():
    """Unquantized f32 params of each reduced arch from the JAX package, and
    the same tree in numpy."""
    out = {}
    for arch in ("internvl2-1b", "musicgen-medium", "qwen2-7b", "minicpm3-4b"):
        jp = j_init_params(jax.random.PRNGKey(0), get_config(arch).reduced())
        out[arch] = (jp, jax.tree.map(np.asarray, jp))
    return out


def serving_pair(weights, arch, scheme=SCHEME, impl="fused_ref"):
    """The reference engine's weight preparation on both sides."""
    jp, npar = weights[arch]
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, jp)
    jpol = JQuantPolicy(scheme=scheme, impl="fused_ref", min_elements=1 << 10)
    tpol = QuantPolicy(scheme=scheme, impl=impl, min_elements=1 << 10)
    return (j_quantize_params(jp, jpol), jpol,
            prepare_params(params_from_numpy(npar), tpol), tpol)


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium"])
def test_zoo_decode_step_logits_match_reference(arch, chunk, weights):
    """Five ticks of the compiled JAX decode step against the port's over
    AMS pages (ref attention), prefix rows fed through the embeds override
    in the first ticks: logits within one bf16 ulp of the largest logits
    (test_torch_engine.py's tolerance), equal argmax, pool bytes equal."""
    cfg = get_config(arch).reduced()
    tcfg = t_get_config(arch).reduced()
    jp, jpol, tp, tpol = serving_pair(weights, arch)
    B = 3
    jcc = JCacheConfig(kind="paged_ams", page_size=PAGE).sized(capacity=CAP, slots=B)
    tcc = CacheConfig(kind="paged_ams", page_size=PAGE).sized(capacity=CAP, slots=B)
    bt = np.arange(B * jcc.max_pages_per_seq, dtype=np.int32).reshape(B, -1)
    emb = cfg.num_prefix_embeds > 0
    step = jax.jit(lambda p, tok, c, pos, nv, e, m: j_decode_step(
        p, tok, c, pos, cfg, policy=jpol, block_tables=jnp.asarray(bt), cache_cfg=jcc,
        nvalid=nv, embeds=e, embed_mask=m))
    step1 = jax.jit(lambda p, tok, c, pos, e, m: j_decode_step(
        p, tok, c, pos, cfg, policy=jpol, block_tables=jnp.asarray(bt), cache_cfg=jcc,
        embeds=e, embed_mask=m))
    jc = j_make_cache(cfg, B, CAP, cache_cfg=jcc)
    tc = make_cache(tcfg, cache_cfg=tcc)
    rng = np.random.default_rng(chunk)
    pos = np.array([0, 2, -1], np.int32)
    for _ in range(5):
        tok = rng.integers(0, cfg.vocab_size, (B, chunk)).astype(np.int32)
        nv = np.array([chunk, max(chunk - 1, 1), 0], np.int32)
        e = rng.standard_normal((B, chunk, cfg.d_model)).astype(np.float32) if emb else None
        m = (pos[:, None] + np.arange(chunk)[None, :] < cfg.num_prefix_embeds) if emb else None
        te = None if e is None else torch.from_numpy(e if chunk > 1 else e[:, 0])
        tm = None if m is None else torch.from_numpy(m if chunk > 1 else m[:, 0])
        je = None if e is None else jnp.asarray(e if chunk > 1 else e[:, 0])
        jm = None if m is None else jnp.asarray(m if chunk > 1 else m[:, 0])
        if chunk == 1:
            lj, jc = step1(jp, jnp.asarray(tok[:, 0]), jc, jnp.asarray(pos), je, jm)
            lt, tc = decode_step(tp, torch.from_numpy(tok[:, 0]), tc, torch.from_numpy(pos),
                                 tcfg, policy=tpol, block_tables=torch.from_numpy(bt),
                                 cache_cfg=tcc, embeds=te, embed_mask=tm)
        else:
            lj, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(pos), jnp.asarray(nv), je, jm)
            lt, tc = decode_step(tp, torch.from_numpy(tok), tc, torch.from_numpy(pos), tcfg,
                                 policy=tpol, block_tables=torch.from_numpy(bt),
                                 cache_cfg=tcc, nvalid=torch.from_numpy(nv), embeds=te,
                                 embed_mask=tm)
        lt, lj = lt.numpy()[:2], np.asarray(lj)[:2]
        np.testing.assert_allclose(lt, lj, rtol=0, atol=2e-2)
        assert (lt.argmax(-1) == lj.argmax(-1)).all()
        pos = pos + np.where(pos >= 0, nv, 0)
    for a, b in zip(jax.tree.leaves(jc["layers"]["sub0"]), tree_leaves(tc["layers"]["sub0"])):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8), b.view(torch.uint8).numpy())


# ---------------------------------------------------- (c) forward_seq
@pytest.mark.parametrize("arch", ["qwen2-7b", "minicpm3-4b", "internvl2-1b"])
def test_forward_seq_matches_reference(arch, weights):
    """Logits of the sequence forward (gqa, mla, gqa with 8 prefix embeds;
    FP5.33 weights) within SEQ_TOL of the jitted JAX forward_seq, equal
    argmax at every position, and its cache bit-equal."""
    cfg = get_config(arch).reduced()
    jp, jpol, tp, tpol = serving_pair(weights, arch)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    pre = (rng.standard_normal((2, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
           if cfg.num_prefix_embeds else None)
    lj, _, cj = jax.jit(lambda p, t, e: j_forward_seq(
        p, t, cfg, policy=jpol, prefix_embeds=e, want_cache=True, remat=False))(
        jp, jnp.asarray(tok), None if pre is None else jnp.asarray(pre))
    lt, aux, ct = forward_seq(tp, torch.from_numpy(tok), t_get_config(arch).reduced(),
                              policy=tpol, want_cache=True,
                              prefix_embeds=None if pre is None else torch.from_numpy(pre))
    lj, lt = np.asarray(lj), lt.numpy()
    assert lt.shape == lj.shape == (2, 12 + cfg.num_prefix_embeds, cfg.vocab_size)
    assert np.abs(lt - lj).max() <= SEQ_TOL * np.abs(lj).max()
    assert (lt.argmax(-1) == lj.argmax(-1)).all() and float(aux) == 0.0
    for k, v in cj["layers"]["sub0"].items():
        np.testing.assert_array_equal(ct["layers"]["sub0"][k].float().numpy(),
                                      np.asarray(v, np.float32))


@pytest.mark.parametrize("arch", ["qwen2-7b", "minicpm3-4b", "internvl2-1b"])
def test_forward_seq_prefill_then_decode(arch, weights):
    """decode(t | cache(prefill(t_0..t_{n-1}))) == forward(t_0..t_n)[-1], as
    the reference's test_prefill_decode_consistency holds it (f32
    activations, 2e-4): the want_cache cache, copied into a larger zero
    cache, continues through `decode_step`."""
    tcfg = t_get_config(arch).reduced()
    params = params_from_numpy(weights[arch][1])
    rng = np.random.default_rng(3)
    B, S = 2, 12
    tok = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32))
    P = tcfg.num_prefix_embeds
    pre = (torch.from_numpy(rng.standard_normal((B, P, tcfg.d_model)).astype(np.float32))
           if P else None)
    f32 = torch.float32
    full, _, _ = forward_seq(params, tok, tcfg, prefix_embeds=pre, dtype=f32)
    _, _, cache = forward_seq(params, tok[:, :-1], tcfg, prefix_embeds=pre, want_cache=True,
                              dtype=f32)
    big = make_cache(tcfg, B, P + S, dtype=f32)
    for dst, src in zip(tree_leaves(big), tree_leaves(cache)):
        dst[:, :, :src.shape[2]] = src
    dec, _ = decode_step(params, tok[:, -1], big, torch.full((B,), P + S - 1, dtype=torch.int32),
                         tcfg, dtype=f32)
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window,prefix_len,block_kv,g", [(0, 0, 1024, 2), (5, 0, 1024, 2),
                                                          (0, 6, 8, 3), (4, 3, 8, 1)])
def test_blockwise_attention_matches_reference(window, prefix_len, block_kv, g):
    """The sequence forward's attention core against the jitted JAX
    blockwise_attention: causal, with a sliding window, with a
    bidirectional prefix, over one or several key blocks, grouped heads;
    within 1e-5 of the largest output (the same bf16 roundings, f32 sums in
    another order)."""
    from repro.models.attention import blockwise_attention as j_blockwise
    from repro.models.attention import kv_index_map as j_kv_index_map
    from repro_torch.models.attention import blockwise_attention

    rng = np.random.default_rng(window + prefix_len + g)
    B, S, kv, hd = 2, 19, 2, 16
    q = rng.standard_normal((B, S, kv * g, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, kv, hd)).astype(np.float32)
    kvm = j_kv_index_map(kv * g, kv * g, kv)
    want = jax.jit(lambda q, k, v: j_blockwise(
        q, k, v, kv_map=kvm, causal=True, window=window, prefix_len=prefix_len,
        block_kv=block_kv))(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = blockwise_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                              window=window, prefix_len=prefix_len, block_kv=block_kv)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, kv * g, hd)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())

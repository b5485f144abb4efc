"""Port parity, contiguous caches: the reference's key-block plan, kernels K4
(GQA cache) and K5 (absorbed-MLA stream), the contiguous inserts, and the
GQA and MLA decode cores, PyTorch port against the JAX package on the CPU.

On the CPU the K4 and K5 wrappers run their plain torch versions; these
tests hold them against the JAX template's contiguous lowering in interpret
mode (p rounded to bf16 at the running max of each ``block_kv`` block) at
its default plan and at a smaller explicit block, and the ``ref`` tier
against the JAX flash-decode bodies. The CUDA kernels themselves are held
against the plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: more intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.policy import QuantPolicy as JQuantPolicy  # noqa: E402
from repro.kernels import attention_template as JT  # noqa: E402
from repro.kernels import tuning as j_tuning  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.common import model_dims as j_model_dims  # noqa: E402
from repro.models.common import quantize_params as j_quantize_params  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.policy import QuantPolicy  # noqa: E402
from repro_torch.kernels import attention_template as T  # noqa: E402
from repro_torch.kernels import tuning  # noqa: E402
from repro_torch.launch.engine import prepare_params  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models.common import model_dims  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402


def bf16_pair(a):
    """numpy f32 -> (JAX bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def to_np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


# ------------------------------------------------------------ block plan
SHAPES = [  # rows (chunk x group), hd, hd_v, cache length
    (7, 128, 128, 512), (112, 128, 128, 512), (40, 288, 256, 512), (640, 288, 256, 512),
    (2, 32, 32, 32), (4, 48, 32, 36), (640, 288, 256, 8192), (4096, 512, 512, 6000),
    (1, 64, 64, 997), (64, 128, 128, 131072)]


@pytest.mark.parametrize("rows,hd,hd_v,s_max", SHAPES)
def test_reference_block_kv_matches_the_plan(rows, hd, hd_v, s_max):
    """The port's block equals the JAX planner's deterministic default
    (a fresh autotune cache, no measuring)."""
    family = "mla" if hd != hd_v else "gqa"
    plan = j_tuning.plan_attention_tiles(kind="contiguous", family=family, scheme=None,
                                         rows=rows, hd=hd, hd_v=hd_v, s_max=s_max, kv_heads=1,
                                         cache=j_tuning.AutotuneCache())
    assert tuning.reference_block_kv(rows=rows, hd=hd, hd_v=hd_v, s_max=s_max) == plan.block_kv
    for bk in (1, 16, plan.block_kv):
        assert tuning.attn_vmem_usage(rows, bk, hd, hd_v) == j_tuning.attn_vmem_usage(
            rows, bk, hd, hd_v)


# ------------------------------------------------------------- K4 and K5
B, S = 3, 32


def case(chunk, mla, seed=0):
    """q, caches and per-query lengths (slot 2 idle; a masked row at chunk
    4) for a GQA cache (kv 2, 4 heads, hd 32) or an MLA stream (one kv
    head, 4 heads, hd 48 of which the first 32 are the values)."""
    rng = np.random.default_rng(seed + chunk + 10 * mla)
    H, kv, hd = (4, 1, 48) if mla else (4, 2, 32)
    q = rng.standard_normal((B, chunk, H, hd) if chunk > 1 else (B, H, hd))
    caches = [rng.standard_normal((B, S, kv, hd)) for _ in range(1 if mla else 2)]
    if chunk == 1:
        lengths = np.array([22, 9, 0], np.int32)
    else:
        lengths = np.array([[20, 21, 22, 0], [6, 7, 8, 9], [0, 0, 0, 0]], np.int32)
    return bf16_pair(q), [bf16_pair(c) for c in caches], lengths


@pytest.mark.parametrize("block_kv", [None, 8])
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("mla", [False, True], ids=["k4", "k5"])
def test_plain_matches_pallas_interpret(mla, chunk, block_kv):
    """K4's / K5's plain version against the JAX template's contiguous
    lowering in interpret mode, compiled as the engine runs it, bit for bit:
    at the default plan (one block: S = 32) and at four blocks of 8, where p
    is rounded at each block's running max (rounding at the global max
    instead moves outputs by about one bf16 ulp, which equality sees)."""
    (qj, qt), caches, lengths = case(chunk, mla)
    scale = 1 / np.sqrt(24) if mla else None
    kw_j = dict(value_slice=32) if mla else dict(v_cache=caches[1][0])
    kw_t = dict(value_slice=32) if mla else dict(v_cache=caches[1][1])
    want = jax.jit(lambda q, k, n: JT.fused_contiguous_attention(
        q, k, n, block_kv=block_kv, scale=scale, interpret=True, **kw_j))(
            qj, caches[0][0], jnp.asarray(lengths))
    count = T.COUNT_MLA if mla else T.COUNT_CONTIG
    launches = count.launches
    got = T.fused_contiguous_attention(qt, caches[0][1], torch.from_numpy(lengths),
                                       block_kv=block_kv, scale=scale, **kw_t)
    assert count.launches == launches               # CPU tensors: no launch
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_array_equal(to_np(got), to_np(want))
    assert np.all(to_np(got)[2] == 0)               # idle slot
    if chunk > 1:
        assert np.all(to_np(got)[0, 3] == 0)        # masked row


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("mla", [False, True], ids=["gqa", "mla"])
@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_attend_contiguous_matches_reference(impl, mla, chunk):
    """The dispatch the model cores call, both lowerings, against the
    compiled JAX dispatch with the matching impl; MLA's kv_map is all zeros
    (one kv head, g = H) and its values are the [..., :32] view of the
    stream."""
    (qj, qt), caches, lengths = case(chunk, mla, seed=5)
    H = 4
    kvm = np.zeros((H,), np.int32) if mla else JA.kv_index_map(H, H, 2)
    if mla:
        vj, vt = caches[0][0][..., :32], caches[0][1][..., :32]
    else:
        vj, vt = caches[1]
    kw = dict(kv_map=kvm, scale=1 / np.sqrt(24) if mla else None,
              value_slice=32 if mla else None)
    jimpl = "pallas_interpret" if impl == "kernel" else "ref"
    want = jax.jit(lambda q, k, v, n: JT.attend_contiguous(q, k, v, n, impl=jimpl, **kw))(
        qj, caches[0][0], vj, jnp.asarray(lengths))
    got = T.attend_contiguous(qt, caches[0][1], vt, torch.from_numpy(lengths), impl=impl, **kw)
    np.testing.assert_array_equal(to_np(got), to_np(want))


def test_contiguous_wrappers_check_shapes():
    (_, qt), caches, lengths = case(4, False)
    qf, lens, _, _ = T._fold_q(qt, torch.from_numpy(lengths), 2, None)
    k, v = caches[0][1], caches[1][1]
    with pytest.raises(ValueError, match="rows"):           # R != c * g
        T.contiguous_attention(qf, k, v, lens, c=4, g=1, block_kv=8)
    with pytest.raises(ValueError, match="divid"):          # block does not divide S
        T.contiguous_attention(qf, k, v, lens, c=4, g=2, block_kv=5)
    with pytest.raises(ValueError, match="cache"):          # kv heads differ from q's
        T.contiguous_attention(qf, k[:, :, :1], v[:, :, :1], lens, c=4, g=2, block_kv=8)
    with pytest.raises(TypeError):
        T.contiguous_attention(qf.double(), k, v, lens, c=4, g=2, block_kv=8)
    out = T.contiguous_attention(qf, k, v, lens, c=4, g=2, block_kv=8)
    assert out.shape == qf.shape and out.dtype == torch.float32
    with pytest.raises(ValueError, match="hd_v"):           # values wider than the stream
        T.contiguous_attention_mla(qf, k, lens, c=4, g=2, block_kv=8, hd_v=64)
    out = T.contiguous_attention_mla(qf, k, lens, c=4, g=2, block_kv=8, hd_v=16)
    assert out.shape == (*qf.shape[:3], 16)
    with pytest.raises(ValueError, match="exactly one"):
        T.fused_contiguous_attention(qt, k, torch.from_numpy(lengths))


# --------------------------------------------------------------- inserts
def test_cache_insert_chunk_bit_equal():
    """Ragged chunk inserts from a non-zero cache: slot 0 full, slot 1 a
    partial chunk, slot 2 idle, slot 3 runs past the end of the cache (its
    dropped rows clamp onto its last valid row's index). Bytes equal the
    reference's, and every position not written is bit-unchanged."""
    rng = np.random.default_rng(3)
    cache0 = rng.standard_normal((4, 16, 2, 8)).astype(np.float32)
    cj, ct = bf16_pair(cache0)
    before = ct.clone()
    pos, nvalid = np.array([0, 5, -1, 14], np.int32), np.array([4, 2, 3, 4], np.int32)
    new_j, new_t = bf16_pair(rng.standard_normal((4, 4, 2, 8)))
    want = jax.jit(JA.cache_insert_chunk)(cj, new_j, jnp.asarray(pos), jnp.asarray(nvalid))
    got = A.cache_insert_chunk(ct, new_t, torch.from_numpy(pos), torch.from_numpy(nvalid))
    assert got is ct                                        # in place
    np.testing.assert_array_equal(np.asarray(want).view(np.uint16),
                                  got.view(torch.int16).numpy().view(np.uint16))
    written = {(0, 0), (0, 1), (0, 2), (0, 3), (1, 5), (1, 6), (3, 14), (3, 15)}
    for b in range(4):
        for t in range(16):
            if (b, t) not in written:
                assert torch.equal(got[b, t].view(torch.int16), before[b, t].view(torch.int16))


@pytest.mark.parametrize("pos", [[0, 15, -1, 7], 6], ids=["per_slot", "scalar"])
def test_cache_insert_bit_equal(pos):
    rng = np.random.default_rng(4)
    cj, ct = bf16_pair(rng.standard_normal((4, 16, 1, 8)))
    new_j, new_t = bf16_pair(rng.standard_normal((4, 1, 1, 8)))
    p = np.asarray(pos, np.int32)
    want = jax.jit(JA.cache_insert)(cj, new_j, jnp.asarray(p))
    got = A.cache_insert(ct, new_t, torch.from_numpy(p))
    np.testing.assert_array_equal(np.asarray(want).view(np.uint16),
                                  got.view(torch.int16).numpy().view(np.uint16))


# ------------------------------------------------------------ MLA pieces
@pytest.fixture(scope="module")
def mla_layer():
    """Layer 0 of the reduced minicpm3-4b, quantized to fp5.33 by each
    package from the same f32 draws."""
    cfg = get_config("minicpm3-4b").reduced()
    jp = j_init_params(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree.map(np.asarray, jp)
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, jp)
    jpol = JQuantPolicy(scheme="fp5.33-e2m3", impl="fused_ref", min_elements=1 << 10)
    jp = j_quantize_params(jp, jpol)
    tpol = QuantPolicy(scheme="fp5.33-e2m3", impl="fused_ref", min_elements=1 << 10)
    tp = prepare_params(params_from_numpy(np_params), tpol)
    lj = jax.tree.map(lambda t: t[0], jp["layers"]["sub0"]["attn"])
    lt = {k: {kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0]
          for k, v in tp["layers"]["sub0"]["attn"].items()}
    tcfg = t_get_config("minicpm3-4b").reduced()
    return (cfg, j_model_dims(cfg), jpol, lj), (tcfg, model_dims(tcfg), tpol, lt)


@pytest.mark.parametrize("S", [1, 4])
def test_mla_projections_bit_equal(S, mla_layer):
    """Absorbed query, compressed stream and output projection (W_uk / W_uv
    dequantized from fp5.33 planes) against the compiled reference."""
    (cfg, jd, jpol, lj), (tcfg, td, tpol, lt) = mla_layer
    rng = np.random.default_rng(S)
    xj, xt = bf16_pair(rng.standard_normal((3, S, cfg.d_model)))
    posn = np.tile(np.arange(S, dtype=np.int32) + 3, (3, 1))
    want = jax.jit(lambda p, x, q: JA._mla_q_eff(p, x, cfg, jd, q, jpol))(lj, xj, posn)
    got = A._mla_q_eff(lt, xt, tcfg, td, torch.from_numpy(posn), tpol)
    np.testing.assert_array_equal(to_np(got), to_np(want))
    want = jax.jit(lambda p, x, q: JA._mla_kv_stream(p, x, cfg, q, jpol))(lj, xj, posn)
    got = A._mla_kv_stream(lt, xt, tcfg, torch.from_numpy(posn), tpol)
    assert got.shape == (3, S, cfg.kv_lora_rank + cfg.qk_rope_dim)
    np.testing.assert_array_equal(to_np(got), to_np(want))
    cj, ct = bf16_pair(rng.standard_normal((3, S, td.H, cfg.kv_lora_rank)))
    want = jax.jit(lambda p, c: JA._mla_out(p, c, cfg, jd, jpol))(lj, cj)
    np.testing.assert_array_equal(to_np(A._mla_out(lt, ct, tcfg, td, tpol)), to_np(want))


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("mla", [False, True], ids=["gqa", "mla"])
@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_decode_cores_match_reference(impl, mla, chunk):
    """Insert + attend cores over a zero cache, slot 2 idle: the written
    caches bit-equal, the outputs equal the JAX core's with the matching
    impl (``kernel`` <-> ``pallas_interpret``), both compiled."""
    rng = np.random.default_rng(chunk + 2 * mla)
    H, kv, hd = (4, 1, 48) if mla else (4, 2, 32)
    jimpl = "pallas_interpret" if impl == "kernel" else "ref"
    pos, nvalid = np.array([0, 5, -1], np.int32), np.array([chunk, max(chunk - 1, 1), 0],
                                                             np.int32)
    qj, qt = bf16_pair(rng.standard_normal((3, chunk, H, hd)))
    news = [bf16_pair(rng.standard_normal((3, chunk, kv, hd))) for _ in range(1 if mla else 2)]
    zj = jnp.zeros((3, 16, kv, hd), jnp.bfloat16)
    zt = [torch.zeros((3, 16, kv, hd), dtype=torch.bfloat16) for _ in news]
    if mla:
        kw = dict(r_kv=32, scale=1 / np.sqrt(24))
        if chunk == 1:
            fj = jax.jit(lambda q, n, c, p: JA.mla_decode_core(q[:, 0], n, c, p, impl=jimpl,
                                                               **kw))
            want = fj(qj, news[0][0], zj, pos)
            got = A.mla_decode_core(qt[:, 0], news[0][1], zt[0], torch.from_numpy(pos),
                                    impl=impl, **kw)
        else:
            fj = jax.jit(lambda q, n, c, p, v: JA.mla_decode_core_chunk(q, n, c, p, v,
                                                                        impl=jimpl, **kw))
            want = fj(qj, news[0][0], zj, pos, nvalid)
            got = A.mla_decode_core_chunk(qt, news[0][1], zt[0], torch.from_numpy(pos),
                                          torch.from_numpy(nvalid), impl=impl, **kw)
    else:
        kvm = JA.kv_index_map(H, H, kv)
        if chunk == 1:
            fj = jax.jit(lambda q, k, v, ck, cv, p: JA.gqa_decode_core(
                q[:, 0], k, v, ck, cv, p, kv_map=kvm, impl=jimpl))
            want = fj(qj, news[0][0], news[1][0], zj, zj, pos)
            got = A.gqa_decode_core(qt[:, 0], news[0][1], news[1][1], zt[0], zt[1],
                                    torch.from_numpy(pos), kv_map=kvm, impl=impl)
        else:
            fj = jax.jit(lambda q, k, v, ck, cv, p, n: JA.gqa_decode_core_chunk(
                q, k, v, ck, cv, p, n, kv_map=kvm, impl=jimpl))
            want = fj(qj, news[0][0], news[1][0], zj, zj, pos, nvalid)
            got = A.gqa_decode_core_chunk(qt, news[0][1], news[1][1], zt[0], zt[1],
                                          torch.from_numpy(pos), torch.from_numpy(nvalid),
                                          kv_map=kvm, impl=impl)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(to_np(b), to_np(a))

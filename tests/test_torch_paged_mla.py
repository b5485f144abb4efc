"""Port parity, the paged absorbed-MLA stream (K5p) and the AMS page formats
of K2.

K5p is `fused_paged_attention(..., value_slice=...)`: one stream pool
(``kv = 1``) whose first ``value_slice`` columns are the values, on bf16
pages (TPU `_make_load_stream`) or AMS pages (`_make_load_ams` with
``hd_v``: only the K planes are restored). Both packages build their pools
with their own `make_gqa_page_pool` / `paged_insert` from the same numpy
inputs; on the CPU the port's wrappers run their plain torch versions,
held here against the JAX Pallas lowering in interpret mode, called as
tests/test_attention_template.py calls it. The CUDA kernels are held
against the plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py).

The JAX insert runs under ``jax.jit``, as the JAX engine step inserts:
eager JAX divides each KV scale by ``max_normal``, where the compiled step
(and the port) multiplies by its f32 reciprocal; eagerly filled pools
differ by one ulp in some scales, and then in codes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: more intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cache import CacheConfig as JCacheConfig  # noqa: E402
from repro.cache import make_gqa_page_pool as j_make_pool  # noqa: E402
from repro.cache import paged_insert as j_insert  # noqa: E402
from repro.kernels.attention_template import fused_paged_attention as j_fused  # noqa: E402
from repro_torch.cache import CacheConfig, make_gqa_page_pool, paged_insert  # noqa: E402
from repro_torch.core.formats import get_scheme  # noqa: E402
from repro_torch.kernels import attention_template as T  # noqa: E402

B, MP, P = 3, 4, 14
SMALL = dict(H=8, hd=72, hd_v=64, page=4)             # ~1 s per JAX interpret call
MINICPM3 = dict(H=40, hd=288, hd_v=256, page=4)       # MiniCPM3-4B's stream widths
KINDS = ("paged_bf16", "paged_ams")


def filled_pools(kind, kv, hd, page, *, kv_scheme="fp4.25-e2m2", seed=0, stream=True):
    """JAX and port pools after the same inserts (chunks of 4 tokens; slot 1
    ragged, one entry short per chunk; slot 2 idle), and the shared block
    table. A stream pool gets its keys as values too: the stream path never
    reads ``v``."""
    kw = dict(kind=kind, page_size=page, num_pages=P, max_pages_per_seq=MP,
              kv_scheme=kv_scheme)
    ccfg_j, ccfg_t = JCacheConfig(**kw), CacheConfig(**kw)
    rng = np.random.default_rng(seed)
    bt = rng.permutation(P)[:B * MP].reshape(B, MP).astype(np.int32)
    pj, pt = j_make_pool(ccfg_j, kv, hd), make_gqa_page_pool(ccfg_t, kv, hd)
    insert = jax.jit(lambda pool, k, v, pos, bt, nv: j_insert(pool, k, v, pos, bt, ccfg_j,
                                                              nvalid=nv))
    c = 4
    for start in range(0, page * MP, c):
        kn = rng.standard_normal((B, c, kv, hd)).astype(np.float32)
        vn = kn if stream else rng.standard_normal((B, c, kv, hd)).astype(np.float32)
        pos = np.array([start, start, -1], np.int32)
        nvalid = np.array([c, c - 1, 0], np.int32)
        pj = insert(pj, jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16),
                    jnp.asarray(pos), jnp.asarray(bt), jnp.asarray(nvalid))
        pt = paged_insert(pt, torch.from_numpy(kn).to(torch.bfloat16),
                          torch.from_numpy(vn).to(torch.bfloat16), torch.from_numpy(pos),
                          torch.from_numpy(bt), ccfg_t, nvalid=torch.from_numpy(nvalid))
    return pj, pt, bt


def query(H, hd, chunk, seed=1, span=1):
    """q and lengths: slot 2 idle; at chunk 4, slot 1's last two rows and
    all of slot 2's are masked (length 0). ``span`` > 1 stretches the
    lengths over ``span`` times as many keys (wide pages)."""
    rng = np.random.default_rng(seed)
    if chunk == 1:
        return (rng.standard_normal((B, H, hd)).astype(np.float32),
                np.array([13, 7, 0], np.int32) * span)
    lengths = np.array([[10, 11, 12, 13], [5, 6, 0, 0], [0, 0, 0, 0]], np.int32)
    if span > 1:
        lengths = np.where(lengths > 0, lengths + 13 * (span - 1), 0).astype(np.int32)
    return rng.standard_normal((B, chunk, H, hd)).astype(np.float32), lengths


def assert_pools_bit_equal(pj, pt, names=("k", "v")):
    for n in names:
        if isinstance(pt[n], dict):
            for pl in ("hi", "lsb", "scale"):
                np.testing.assert_array_equal(np.asarray(pj[n][pl]).view(np.uint8),
                                              pt[n][pl].numpy().view(np.uint8), err_msg=(n, pl))
        else:
            np.testing.assert_array_equal(np.asarray(pj[n]).view(np.uint16),
                                          pt[n].view(torch.int16).numpy().view(np.uint16),
                                          err_msg=n)


def assert_close(got, want, extra=0.0):
    """Within 2e-6 + 1e-6 |want| (f32 summation order; the reference's own
    AMS-page tolerance) in all but at most 1 % of the elements, and those
    within ``extra`` more (0: all of them)."""
    strict = 2e-6 + 1e-6 * np.abs(want)
    diff = np.abs(got - want)
    assert np.all(diff <= strict + extra), float((diff - strict - extra).max())
    assert np.mean(diff > strict) <= 0.01, float(np.mean(diff > strict))


def rounding_allowance(kind, q_t, pt, lengths, bt, page, hd_v):
    """What rounding to bf16 lets the port and the Pallas lowering differ
    by, element by element: on bf16 pages both round p to bf16 at each
    page's running max, but q.k summed in another f32 order (torch's and
    XLA's CPU products differ in the last bit) can put a p one bf16 ulp, at
    most 2^-7 of itself, apart: 2^-7 A, A = sum_i bf16(p_i) |v_i| / l (the
    plain walk over |v| with the same p); bf16 outputs (bf16 q) can then
    round one bf16 ulp apart, at most 2^-7 of the value. AMS pages with f32
    q: 0."""
    extra = 0.0
    if kind == "paged_bf16":
        qf, lens, chunked, dims = T._fold_q(q_t, torch.from_numpy(lengths), 1, None)
        k = pt["k"]

        def load(pg):
            kb = k[pg].float()
            return kb, kb[..., :hd_v].abs()

        a = T._paged_online_softmax(qf, load, lens, torch.from_numpy(bt), page_size=page,
                                    c=dims[1], g=dims[4], pv_dtype=torch.bfloat16, hd_v=hd_v)
        extra = 2.0 ** -7 * T._unfold_o(a, dims, chunked, torch.float32).numpy()
    return extra


def k5p_case(kind, widths, chunk, q_dtype, kv_scheme="fp4.25-e2m2"):
    """(port output, JAX interpret output, lengths, rounding allowance) of
    one K5p call."""
    H, hd, hd_v, page = (widths[k] for k in ("H", "hd", "hd_v", "page"))
    pj, pt, bt = filled_pools(kind, 1, hd, page, kv_scheme=kv_scheme)
    assert_pools_bit_equal(pj, pt)
    q, lengths = query(H, hd, chunk, span=widths.get("span", 1))
    scheme = kv_scheme if kind == "paged_ams" else None
    jd, td = (jnp.float32, torch.float32) if q_dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = j_fused(jnp.asarray(q, jd), pj, jnp.asarray(lengths), jnp.asarray(bt),
                   page_size=page, kv_scheme=scheme, value_slice=hd_v, interpret=True)
    counts = [(c.launches, c.plain_on_cuda) for c in (T.COUNT_STREAM_BF16, T.COUNT_STREAM_AMS)]
    q_t = torch.from_numpy(q).to(td)
    got = T.fused_paged_attention(q_t, pt, torch.from_numpy(lengths), torch.from_numpy(bt),
                                  page_size=page, kv_scheme=scheme, value_slice=hd_v)
    # CPU tensors: the plain version, no launch
    assert [(c.launches, c.plain_on_cuda)
            for c in (T.COUNT_STREAM_BF16, T.COUNT_STREAM_AMS)] == counts
    assert got.dtype == td and tuple(got.shape) == want.shape
    assert got.shape[-1] == hd_v
    want = np.asarray(want.astype(jnp.float32))
    extra = rounding_allowance(kind, q_t, pt, lengths, bt, page, hd_v)
    if q_dtype == "bf16":
        extra = extra + 2.0 ** -7 * np.abs(want)
    return got.float().numpy(), want, lengths, extra


# ------------------------------------------------------------------- K5p
@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_k5p_matches_pallas_interpret(kind, chunk, q_dtype):
    """The same rounding points as the Pallas lowering (bf16 pages: p
    rounded to bf16 at each page's running max; AMS pages: p in f32 over
    exact lattice values), so only f32 summation order differs, and what
    it moves through a bf16 rounding (`rounding_allowance`)."""
    got, want, lengths, extra = k5p_case(kind, SMALL, chunk, q_dtype)
    assert_close(got, want, extra)
    assert np.all(got[lengths == 0] == 0)       # idle slot, masked rows


@pytest.mark.parametrize("kind", KINDS)
def test_k5p_matches_pallas_interpret_at_minicpm3_widths(kind):
    """40 heads on one stream of 256 + 32 columns, values its first 256."""
    got, want, lengths, extra = k5p_case(kind, MINICPM3, 4, "f32")
    assert_close(got, want, extra)
    assert np.all(got[lengths == 0] == 0)


WIDE = dict(SMALL, page=64, span=12)                 # pages the kernel walks in 2 sub-tiles


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_k5p_at_page_64_matches_pallas_interpret(kind, chunk):
    """Pages of 64 tokens (the Pallas kernel takes a whole page as one
    block; the CUDA walk takes it in two sub-tiles of 32 with one max per
    page), lengths up to 156 keys: over three pages."""
    got, want, lengths, extra = k5p_case(kind, WIDE, chunk, "f32")
    assert lengths.max() > 2 * WIDE["page"]
    assert_close(got, want, extra)
    assert np.all(got[lengths == 0] == 0)


def test_k5p_on_e2m1_pages_matches_pallas_interpret():
    got, want, lengths, extra = k5p_case("paged_ams", SMALL, 4, "f32", kv_scheme="fp4-e2m1")
    assert_close(got, want, extra)
    assert np.all(got[lengths == 0] == 0)


@pytest.mark.parametrize("kind", KINDS)
def test_k5p_reads_only_the_k_leaf(kind):
    """A pool without its ``v`` leaf (which the stream path never reads)
    gives the same bits."""
    _, pt, bt = filled_pools(kind, 1, SMALL["hd"], SMALL["page"])
    q, lengths = query(SMALL["H"], SMALL["hd"], 4)
    scheme = "fp4.25-e2m2" if kind == "paged_ams" else None
    kw = dict(page_size=SMALL["page"], kv_scheme=scheme, value_slice=SMALL["hd_v"])
    args = (torch.from_numpy(q), torch.from_numpy(lengths), torch.from_numpy(bt))
    full = T.fused_paged_attention(args[0], pt, *args[1:], **kw)
    k_only = T.fused_paged_attention(args[0], {"k": pt["k"]}, *args[1:], **kw)
    assert torch.equal(full, k_only)


def test_k5p_wrappers_check_shapes():
    hd, page = 16, 4
    _, pb, bt = filled_pools("paged_bf16", 1, hd, page)
    _, pa, _ = filled_pools("paged_ams", 1, hd, page)
    scheme = get_scheme("fp4.25-e2m2")
    qf = torch.zeros((B, 1, 4, hd))
    lens = torch.ones(B, dtype=torch.int32)
    bt = torch.from_numpy(bt)
    bf16 = T.paged_attention_stream_bf16
    ams = T.paged_attention_stream_ams
    kw = dict(page_size=page, c=1, g=4, hd_v=8)
    with pytest.raises(ValueError, match="value_slice"):
        bf16(qf, pb, lens, bt, **{**kw, "hd_v": hd + 1})
    with pytest.raises(ValueError, match="value_slice"):
        ams(qf, pa, lens, bt, scheme=scheme, **{**kw, "hd_v": 0})
    with pytest.raises(ValueError, match="bf16"):              # page size differs
        bf16(qf, pb, lens, bt, **{**kw, "page_size": 2 * page})
    with pytest.raises(ValueError, match="bf16"):              # f32 pool
        bf16(qf, {"k": pb["k"].float()}, lens, bt, **kw)
    with pytest.raises(ValueError, match="pool plane"):        # page size differs
        ams(qf, pa, lens, bt, scheme=scheme, **{**kw, "page_size": 2 * page})
    with pytest.raises(ValueError, match="pool plane"):        # q wider than the planes
        ams(torch.zeros((B, 1, 4, 2 * hd)), pa, lens, bt, scheme=scheme, **kw)
    with pytest.raises(ValueError, match="rows"):              # R != c * g
        bf16(qf, pb, lens, bt, **{**kw, "g": 2})
    with pytest.raises(ValueError, match="block_table"):
        ams(qf, pa, lens, bt[:2], scheme=scheme, **kw)
    with pytest.raises(TypeError):
        bf16(qf.double(), pb, lens, bt, **kw)
    with pytest.raises(NotImplementedError, match="5 bits"):   # e2m3 codes: 6 bits
        ams(qf, pa, lens, bt, scheme=get_scheme("fp5.33-e2m3"), **kw)
    for fn, extra in ((bf16, {}), (ams, {"scheme": scheme})):
        out = fn(qf, pb if fn is bf16 else pa, lens, bt, **kw, **extra)
        assert out.shape == (B, 1, 4, 8) and out.dtype == torch.float32


# -------------------------------------------------- K2 on other AMS schemes
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("kv_scheme", ["fp4-e2m1", "fp4.5-e2m2", "fp4.33-e2m2"])
def test_k2_page_schemes_match_pallas_interpret(kv_scheme, chunk):
    """K2's plain version over AMS pages of e2m1 codes (the nibble plane
    holds their top 3 bits, the LSB plane their mantissa bit, k = 1) and of
    e2m2 codes shared by k = 2 and 3, at GQA widths (2 kv heads, g = 4)."""
    pj, pt, bt = filled_pools("paged_ams", 2, 32, 4, kv_scheme=kv_scheme, stream=False)
    assert_pools_bit_equal(pj, pt)
    q, lengths = query(8, 32, chunk, seed=2)
    want = np.asarray(j_fused(jnp.asarray(q), pj, jnp.asarray(lengths), jnp.asarray(bt),
                              page_size=4, kv_scheme=kv_scheme, interpret=True))
    launches = T.COUNT.launches
    got = T.fused_paged_attention(torch.from_numpy(q), pt, torch.from_numpy(lengths),
                                  torch.from_numpy(bt), page_size=4,
                                  kv_scheme=kv_scheme).numpy()
    assert T.COUNT.launches == launches
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-6)
    assert np.all(got[lengths == 0] == 0)


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("kv_scheme", ["fp4.25-e2m2", "fp4-e2m1"])
def test_k2_at_page_64_matches_pallas_interpret(kv_scheme, chunk):
    """K2 over AMS pages of 64 tokens at GQA widths (2 kv heads, g = 4),
    lengths up to 156 keys: over three pages."""
    pj, pt, bt = filled_pools("paged_ams", 2, 32, 64, kv_scheme=kv_scheme, stream=False)
    assert_pools_bit_equal(pj, pt)
    q, lengths = query(8, 32, chunk, seed=3, span=12)
    assert lengths.max() > 128
    want = np.asarray(j_fused(jnp.asarray(q), pj, jnp.asarray(lengths), jnp.asarray(bt),
                              page_size=64, kv_scheme=kv_scheme, interpret=True))
    got = T.fused_paged_attention(torch.from_numpy(q), pt, torch.from_numpy(lengths),
                                  torch.from_numpy(bt), page_size=64,
                                  kv_scheme=kv_scheme).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-6)
    assert np.all(got[lengths == 0] == 0)


def test_k2_rejects_codes_wider_than_the_nibble_plane():
    _, pt, bt = filled_pools("paged_ams", 2, 32, 4, stream=False)
    qf = torch.zeros((B, 2, 4, 32))
    with pytest.raises(NotImplementedError, match="5 bits"):
        T.paged_attention_ams(qf, pt, torch.ones(B, dtype=torch.int32), torch.from_numpy(bt),
                              page_size=4, scheme=get_scheme("fp5.33-e2m3"), c=1, g=4)

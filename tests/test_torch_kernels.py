"""Port parity, kernels: K1 / K1b (AMS matmul, fp533 / planes containers), K2
(paged AMS attention) and K3 (paged attention over bf16 pages).

On the CPU each wrapper runs its kernel's plain torch version; these tests
hold the plain versions against the JAX package's Pallas kernels in
interpret mode and against its plain oracles, on the same numpy inputs.
The CUDA kernels themselves are held against the plain versions on the
card (tests/test_torch_gpu.py, chip_smoke.py).
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
from repro.cache import paged_attention_ref as j_paged_ref  # noqa: E402
from repro.cache import paged_insert as j_insert  # noqa: E402
from repro.core import get_scheme, quantize_linear  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.attention_template import fused_paged_attention as j_fused  # noqa: E402
from repro.models.attention import kv_index_map  # noqa: E402
from repro_torch.cache import CacheConfig  # noqa: E402
from repro_torch.cache import make_gqa_page_pool, paged_attention_ref, paged_insert  # noqa: E402
from repro_torch.core.formats import get_scheme as t_get_scheme  # noqa: E402
from repro_torch.core.packing import PackedWeight, make_layout  # noqa: E402
from repro_torch.kernels import ams_matmul as t_k1  # noqa: E402
from repro_torch.kernels import attention_template as t_k2  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def packed_pair(K, N, scheme="fp5.33-e2m3", seed=0):
    """The JAX QuantizedLinear and the same planes as a port PackedWeight."""
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((K, N)).astype(np.float32) * 0.02)
    q = quantize_linear(w, get_scheme(scheme))
    p = q.packed
    pw = PackedWeight(torch.from_numpy(np.array(p.hi)), torch.from_numpy(np.array(p.lsb)),
                      torch.from_numpy(np.array(p.scale)),
                      make_layout(t_get_scheme(scheme)), K, N)
    return q, pw


# ------------------------------------------------------------------- K1
@pytest.mark.parametrize("K,N,B", [(128, 128, 1), (700, 300, 5), (1536, 512, 16),
                                   (384, 1, 2), (1, 256, 3), (2048, 640, 33)])
def test_k1_plain_matches_pallas_interpret(K, N, B):
    q, pw = packed_pair(K, N, seed=K + N + B)
    x = np.random.default_rng(B).standard_normal((B, K)).astype(np.float32)
    want = j_ops.ams_matmul(jnp.asarray(x), q.packed, interpret=True)
    launches = t_k1.COUNT.launches
    got = t_ops.ams_matmul(torch.from_numpy(x), pw)
    assert t_k1.COUNT.launches == launches          # CPU tensors: no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_plain_dtype_and_leading_dims(dtype):
    q, pw = packed_pair(384, 256, seed=11)
    x = np.random.default_rng(11).standard_normal((2, 4, 384)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = j_ops.ams_matmul(xj, q.packed, interpret=True)
    got = t_ops.ams_matmul(xt, pw)
    assert got.shape == (2, 4, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_k1_decode_bit_exact_identity():
    """One-hot activations read the restored weight rows back exactly: the
    plain decode equals the reference's table decode bit for bit."""
    K, N = 384, 128
    q, pw = packed_pair(K, N, seed=16)
    eye = np.eye(8, K, dtype=np.float32)
    got = t_ops.ams_matmul(torch.from_numpy(eye), pw).numpy()
    want = np.asarray(j_ref.dequant_full(q.packed))[:8]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, t_ref.dequant_full(pw).numpy()[:8])
    pallas = np.asarray(j_ops.ams_matmul(jnp.asarray(eye), q.packed, interpret=True))
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("scheme,K,N,B", [("fp5.33-e2m3", 999, 160, 6),
                                          ("fp4.25-e2m2", 999, 160, 6),
                                          ("fp5.33-e2m3", 1030, 96, 3)])
def test_fused_ref_and_ref_match_reference(scheme, K, N, B):
    q, pw = packed_pair(K, N, scheme, seed=15)
    x = np.random.default_rng(15).standard_normal((B, K)).astype(np.float32)
    np.testing.assert_allclose(
        t_ref.ams_matmul_blocked(torch.from_numpy(x), pw).numpy(),
        np.asarray(j_ref.ams_matmul_blocked(jnp.asarray(x), q.packed)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        t_ref.ams_matmul_ref(torch.from_numpy(x), pw).numpy(),
        np.asarray(j_ref.ams_matmul_ref(jnp.asarray(x), q.packed)), rtol=1e-5, atol=1e-5)


PLANES_SCHEMES = ("fp8", "fp6-e2m3", "fp6-e3m2", "fp5-e2m2", "fp4.5-e2m2", "fp4.33-e2m2",
                  "fp4.25-e2m2", "fp4-e2m1")


@pytest.mark.parametrize("scheme", PLANES_SCHEMES)
@pytest.mark.parametrize("K,N,B", [(300, 130, 5), (1, 40, 2), (700, 257, 9)])
def test_k1b_plain_matches_pallas_interpret(scheme, K, N, B):
    """Every planes scheme (per_word 4/5/6/8, k 1-4, biases 1/3/7) at ragged
    B/K/N through ops.ams_matmul -> K1b's plain version, against the JAX
    planes kernel in interpret mode."""
    q, pw = packed_pair(K, N, scheme, seed=K + N)
    assert pw.layout.container == "planes"
    x = np.random.default_rng(B).standard_normal((B, K)).astype(np.float32)
    want = j_ops.ams_matmul(jnp.asarray(x), q.packed, interpret=True)
    launches = t_k1.COUNT_PLANES.launches
    got = t_ops.ams_matmul(torch.from_numpy(x), pw)
    assert t_k1.COUNT_PLANES.launches == launches   # CPU tensors: no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scheme", ["fp4.25-e2m2", "fp8", "fp6-e3m2"])
def test_k1b_decode_bit_exact_identity(scheme):
    """One-hot activations read the restored fp4.25 (and e4m3 / e3m2) weight
    rows back exactly: K1b's plain decode equals the reference's table
    decode and its Pallas kernel bit for bit."""
    K, N = 384, 128
    q, pw = packed_pair(K, N, scheme, seed=16)
    eye = np.eye(8, K, dtype=np.float32)
    got = t_ops.ams_matmul(torch.from_numpy(eye), pw).numpy()
    want = np.asarray(j_ref.dequant_full(q.packed))[:8]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, t_ref.dequant_full(pw).numpy()[:8])
    pallas = np.asarray(j_ops.ams_matmul(jnp.asarray(eye), q.packed, interpret=True))
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("scheme", PLANES_SCHEMES)
def test_planes_layouts_match_reference_at_qwen_widths(scheme):
    """Every planes scheme's layout equals the reference's, and K pads alike
    at the Qwen2-7B widths (fp4.25: k_block = lcm(8, 128) = 128, which
    divides both)."""
    from repro.core.packing import make_layout as j_make_layout
    jl, tl = j_make_layout(get_scheme(scheme)), make_layout(t_get_scheme(scheme))
    assert (tl.container, tl.hi_bits, tl.per_word, tl.k_block) == (
        jl.container, jl.hi_bits, jl.per_word, jl.k_block)
    for K in (3584, 18944):
        assert tl.padded_k(K) == jl.padded_k(K)
    if scheme == "fp4.25-e2m2":
        assert tl.k_block == 128 and (tl.padded_k(3584), tl.padded_k(18944)) == (3584, 18944)


@pytest.mark.parametrize("scheme", PLANES_SCHEMES)
def test_fused_ref_matches_reference_every_planes_scheme(scheme):
    """The fused_ref path (K-blocked product) for every planes scheme at a
    ragged shape, against the reference's blocked product."""
    q, pw = packed_pair(999, 160, scheme, seed=17)
    x = np.random.default_rng(17).standard_normal((6, 999)).astype(np.float32)
    np.testing.assert_allclose(
        t_ref.ams_matmul_blocked(torch.from_numpy(x), pw).numpy(),
        np.asarray(j_ref.ams_matmul_blocked(jnp.asarray(x), q.packed)), rtol=1e-5, atol=1e-5)


def test_k1b_wrapper_checks_shapes():
    _, pw = packed_pair(256, 64, "fp4.25-e2m2")
    lay = pw.layout
    with pytest.raises(ValueError):                 # K not a multiple of k_block
        t_k1.ams_matmul_planes(torch.zeros((2, 255)), pw.hi, pw.lsb, pw.scale, lay)
    with pytest.raises(ValueError):                 # lsb rows != Kp / (32k)
        t_k1.ams_matmul_planes(torch.zeros((2, 256)), pw.hi, pw.lsb[:1], pw.scale, lay)
    with pytest.raises(TypeError):
        t_k1.ams_matmul_planes(torch.zeros((2, 256)), pw.hi, pw.lsb.float(), pw.scale, lay)
    _, p533 = packed_pair(96, 64)
    with pytest.raises(ValueError, match="planes"):
        t_k1.ams_matmul_planes(torch.zeros((2, 96)), p533.hi, p533.lsb, p533.scale,
                               p533.layout)


def test_k1_wrapper_checks_shapes():
    _, pw = packed_pair(96, 64)
    with pytest.raises(ValueError):
        t_k1.ams_matmul_fp533(torch.zeros((2, 95)), pw.hi, pw.scale)
    with pytest.raises(TypeError):
        t_k1.ams_matmul_fp533(torch.zeros((2, 96)), pw.hi.float(), pw.scale)


# ------------------------------------------------------------------- K2
KV, HD, H, PAGE, MP = 2, 32, 8, 8, 4


def filled_pools(c=4, seed=3):
    """JAX and port AMS pools after the same inserts (idle slot 2, ragged
    nvalid), plus the shared block table."""
    ccfg_j = JCacheConfig(kind="paged_ams", page_size=PAGE, num_pages=14,
                          max_pages_per_seq=MP)
    ccfg_t = CacheConfig(kind="paged_ams", page_size=PAGE, num_pages=14,
                         max_pages_per_seq=MP)
    rng = np.random.default_rng(seed)
    bt = rng.permutation(14)[:12].reshape(3, MP).astype(np.int32)
    pj = j_make_pool(ccfg_j, KV, HD)
    pt = make_gqa_page_pool(ccfg_t, KV, HD)
    # compiled, as the reference's engine step inserts (see test_torch_core)
    insert = jax.jit(lambda pool, k, v, pos, bt, nv: j_insert(pool, k, v, pos, bt, ccfg_j,
                                                              nvalid=nv))
    for start in range(0, 24, c):
        kn = rng.standard_normal((3, c, KV, HD)).astype(np.float32)
        vn = rng.standard_normal((3, c, KV, HD)).astype(np.float32)
        pos = np.array([start, start + 1, -1], np.int32)
        nvalid = np.array([c, c - 1, 0], np.int32)
        pj = insert(pj, jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16),
                    jnp.asarray(pos), jnp.asarray(bt), jnp.asarray(nvalid))
        pt = paged_insert(pt, torch.from_numpy(kn).to(torch.bfloat16),
                          torch.from_numpy(vn).to(torch.bfloat16), torch.from_numpy(pos),
                          torch.from_numpy(bt), ccfg_t, nvalid=torch.from_numpy(nvalid))
    return pj, pt, bt, ccfg_j, ccfg_t


def test_paged_insert_pool_planes_byte_equal():
    pj, pt, *_ = filled_pools()
    for n in ("k", "v"):
        for pl in ("hi", "lsb", "scale"):
            np.testing.assert_array_equal(np.asarray(pj[n][pl]).view(np.uint8),
                                          pt[n][pl].numpy().view(np.uint8), err_msg=(n, pl))


def query(chunk, seed=4):
    rng = np.random.default_rng(seed)
    if chunk == 1:
        q = rng.standard_normal((3, H, HD)).astype(np.float32)
        lengths = np.array([22, 9, 0], np.int32)            # slot 2 idle
    else:
        q = rng.standard_normal((3, chunk, H, HD)).astype(np.float32)
        lengths = np.array([[20, 21, 22, 0], [6, 7, 8, 9], [0, 0, 0, 0]], np.int32)
    return q, lengths


@pytest.mark.parametrize("chunk", [1, 4])
def test_k2_plain_matches_ref_oracle(chunk):
    pj, pt, bt, ccfg_j, ccfg_t = filled_pools()
    q, lengths = query(chunk)
    kvm = kv_index_map(H, H, KV)
    want = np.asarray(j_paged_ref(jnp.asarray(q), pj, jnp.asarray(lengths), jnp.asarray(bt),
                                  ccfg_j, kv_map=kvm))
    launches = t_k2.COUNT.launches
    got = t_k2.fused_paged_attention(torch.from_numpy(q), pt, torch.from_numpy(lengths),
                                     torch.from_numpy(bt), page_size=PAGE,
                                     kv_scheme="fp4.25-e2m2").numpy()
    assert t_k2.COUNT.launches == launches
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-6)
    # idle slot and masked rows: exact zeros
    assert np.all(got[2] == 0)
    if chunk > 1:
        assert np.all(got[0, 3] == 0)
    # the port's own gather-dequantize oracle agrees with the reference's
    ref_t = paged_attention_ref(torch.from_numpy(q), pt, torch.from_numpy(lengths),
                                torch.from_numpy(bt), ccfg_t, kv_map=kvm).numpy()
    np.testing.assert_allclose(ref_t, want, atol=2e-6, rtol=1e-6)


def test_k2_plain_matches_pallas_interpret():
    pj, pt, bt, _, _ = filled_pools(c=2, seed=8)
    q, lengths = query(4, seed=9)
    want = np.asarray(j_fused(jnp.asarray(q), pj, jnp.asarray(lengths), jnp.asarray(bt),
                              page_size=PAGE, kv_scheme="fp4.25-e2m2", interpret=True))
    got = t_k2.fused_paged_attention(torch.from_numpy(q), params_from_numpy(to_np(pj)),
                                     torch.from_numpy(lengths), torch.from_numpy(bt),
                                     page_size=PAGE, kv_scheme="fp4.25-e2m2").numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-6)


# ------------------------------------------------------------------- K3
def filled_bf16_pools(c=4, seed=3):
    """filled_pools' inserts into bf16 page pools."""
    ccfg_j = JCacheConfig(kind="paged_bf16", page_size=PAGE, num_pages=14,
                          max_pages_per_seq=MP)
    ccfg_t = CacheConfig(kind="paged_bf16", page_size=PAGE, num_pages=14,
                         max_pages_per_seq=MP)
    rng = np.random.default_rng(seed)
    bt = rng.permutation(14)[:12].reshape(3, MP).astype(np.int32)
    pj = j_make_pool(ccfg_j, KV, HD)
    pt = make_gqa_page_pool(ccfg_t, KV, HD)
    insert = jax.jit(lambda pool, k, v, pos, bt, nv: j_insert(pool, k, v, pos, bt, ccfg_j,
                                                              nvalid=nv))
    for start in range(0, 24, c):
        kn = rng.standard_normal((3, c, KV, HD)).astype(np.float32)
        vn = rng.standard_normal((3, c, KV, HD)).astype(np.float32)
        pos = np.array([start, start + 1, -1], np.int32)
        nvalid = np.array([c, c - 1, 0], np.int32)
        pj = insert(pj, jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16),
                    jnp.asarray(pos), jnp.asarray(bt), jnp.asarray(nvalid))
        pt = paged_insert(pt, torch.from_numpy(kn).to(torch.bfloat16),
                          torch.from_numpy(vn).to(torch.bfloat16), torch.from_numpy(pos),
                          torch.from_numpy(bt), ccfg_t, nvalid=torch.from_numpy(nvalid))
    return pj, pt, bt, ccfg_j, ccfg_t


@pytest.mark.parametrize("c", [1, 4])
def test_paged_insert_bf16_pool_bytes_equal(c):
    pj, pt, *_ = filled_bf16_pools(c=c)
    for n in ("k", "v"):
        assert pt[n].dtype == torch.bfloat16 and pt[n].shape == pj[n].shape
        np.testing.assert_array_equal(np.asarray(pj[n]).view(np.uint16),
                                      pt[n].view(torch.int16).numpy().view(np.uint16),
                                      err_msg=n)


@pytest.mark.parametrize("chunk", [1, 4])
def test_k3_plain_matches_pallas_interpret(chunk):
    """K3's plain version against the JAX template's bf16-page lowering
    (_load_pair, p rounded to bf16 at the running max, page by page): the
    same rounding points, so only f32 summation order differs; a score one
    f32 ulp apart can round p to a neighbouring bf16 value, which moves an
    output by at most 2^-8 of one p * |v| term."""
    pj, pt, bt, _, _ = filled_bf16_pools(c=2, seed=8)
    q, lengths = query(chunk, seed=9)
    want = np.asarray(j_fused(jnp.asarray(q), pj, jnp.asarray(lengths), jnp.asarray(bt),
                              page_size=PAGE, kv_scheme=None, interpret=True))
    launches = t_k2.COUNT_BF16.launches
    got = t_k2.fused_paged_attention(torch.from_numpy(q), pt, torch.from_numpy(lengths),
                                     torch.from_numpy(bt), page_size=PAGE,
                                     kv_scheme=None).numpy()
    assert t_k2.COUNT_BF16.launches == launches    # CPU tensors: no launch
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-6)
    assert np.all(got[2] == 0)                      # idle slot
    if chunk > 1:
        assert np.all(got[0, 3] == 0)               # masked row


@pytest.mark.parametrize("chunk", [1, 4])
def test_k3_plain_matches_ref_oracle(chunk):
    """Against the gather -> attend oracle in q's dtype (bf16 q: p rounded
    to bf16 at the GLOBAL max, the reference's own 2e-3/2e-2 bf16-page
    tolerance), and the port's oracle against the reference's."""
    pj, pt, bt, ccfg_j, ccfg_t = filled_bf16_pools()
    q, lengths = query(chunk)
    kvm = kv_index_map(H, H, KV)
    qj, qt = jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).to(torch.bfloat16)
    want = np.asarray(j_paged_ref(qj, pj, jnp.asarray(lengths), jnp.asarray(bt), ccfg_j,
                                  kv_map=kvm).astype(jnp.float32))
    got = t_k2.fused_paged_attention(qt, pt, torch.from_numpy(lengths), torch.from_numpy(bt),
                                     page_size=PAGE, kv_scheme=None)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-3, rtol=2e-2)
    assert np.all(got.float().numpy()[2] == 0)
    ref_t = paged_attention_ref(qt, pt, torch.from_numpy(lengths), torch.from_numpy(bt),
                                ccfg_t, kv_map=kvm)
    assert ref_t.dtype == torch.bfloat16
    # same rounding points as the reference's oracle: f32 sums in another order
    np.testing.assert_allclose(ref_t.float().numpy(), want, atol=1e-2, rtol=1e-2)


def test_k3_wrapper_checks_shapes():
    _, pt, bt, _, _ = filled_bf16_pools()
    qf = torch.zeros((3, KV, 4, HD))
    lens = torch.ones(3, dtype=torch.int32)
    bt = torch.from_numpy(bt)
    with pytest.raises(ValueError, match="bf16"):    # page size differs from the pool's
        t_k2.paged_attention_bf16(qf, pt, lens, bt, page_size=PAGE * 2, c=1, g=4)
    with pytest.raises(ValueError, match="bf16"):    # f32 pool
        t_k2.paged_attention_bf16(qf, {n: t.float() for n, t in pt.items()}, lens, bt,
                                  page_size=PAGE, c=1, g=4)
    with pytest.raises(ValueError, match="rows"):    # R != c * g
        t_k2.paged_attention_bf16(qf, pt, lens, bt, page_size=PAGE, c=1, g=2)
    with pytest.raises(TypeError):
        t_k2.paged_attention_bf16(qf.double(), pt, lens, bt, page_size=PAGE, c=1, g=4)
    out = t_k2.paged_attention_bf16(qf, pt, lens, bt, page_size=PAGE, c=1, g=4)
    assert out.shape == qf.shape and out.dtype == torch.float32

"""Port parity, kernels: K1 (AMS fp533 matmul) and K2 (paged AMS attention).

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


def test_k1_planes_container_is_not_ported():
    _, pw = packed_pair(256, 64, "fp4.25-e2m2")
    with pytest.raises(NotImplementedError, match="K1b"):
        t_ops.ams_matmul(torch.zeros((1, 256)), pw)


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


def test_k2_bf16_pages_are_not_ported():
    with pytest.raises(NotImplementedError, match="K3"):
        t_k2.fused_paged_attention(torch.zeros((1, 2, 8)), {}, torch.ones(1, dtype=torch.int32),
                                   torch.zeros((1, 1), dtype=torch.int32), page_size=8,
                                   kv_scheme=None)

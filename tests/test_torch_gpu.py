"""Tests of the port that need the card, plus import hygiene.

The ``gpu``-marked tests hold the CUDA kernels K1, K1b, K2, K3, K4, K5 and
K5p against their plain torch versions on the card, at small and at
Qwen2-7B / MiniCPM3-4B / Falcon-Mamba-7B widths, run the engine end to end
through each path's kernels, and hold its CUDA-graph step against the
eager step (Falcon-Mamba-7B at full width, 2 layers, too). Each skips from inside the test
when ``torch.cuda.is_available()`` is false. The machine with the card has
no JAX, so this file imports none; run it there alone:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

The hygiene tests run everywhere: no module of the port (and not
chip_smoke.py) imports jax or the JAX package.
"""

import ast
import math
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def packed(K, N, dev, seed=0, scheme="fp5.33-e2m3", container=None):
    """A random [K, N] weight packed by ``scheme`` (a registered name or an
    AMSFormat) into ``container`` (the scheme's default when None)."""
    from repro_torch.core.ams import ams_quantize
    from repro_torch.core.formats import get_scheme
    from repro_torch.core.packing import make_layout, pack

    scheme = get_scheme(scheme) if isinstance(scheme, str) else scheme
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)
    Kp = make_layout(scheme, container).padded_k(K)
    codes, scale = ams_quantize(torch.nn.functional.pad(w, (0, 0, 0, Kp - K)), scheme)
    return pack(codes, scale, scheme, container), gen


@pytest.mark.gpu
@pytest.mark.parametrize("K,N,B", [(128, 128, 1), (700, 300, 5), (2048, 640, 33),
                                   (3584, 512, 8), (3584, 18944, 8), (18944, 3584, 128),
                                   # InternVL2-1B's projections, and a sequence forward's rows
                                   (896, 128, 8), (896, 4864, 8), (4864, 896, 128),
                                   (896, 896, 256),
                                   # Falcon-Mamba-7B's in_proj, x_proj (ragged N 288),
                                   # dt_proj (Kp 258: 43 words) and out_proj
                                   (4096, 16384, 8), (8192, 288, 8), (256, 8192, 8),
                                   (8192, 4096, 8), (8192, 288, 128), (256, 8192, 128)])
def test_k1_kernel_matches_plain(K, N, B):
    from repro_torch.kernels.ams_matmul import COUNT, ams_matmul_fp533, ams_matmul_fp533_plain

    dev = cuda_device()
    pw, gen = packed(K, N, dev, seed=K + N)
    x = torch.zeros((B, pw.hi.shape[0] * 6), device=dev)
    x[:, :K] = torch.randn((B, K), generator=gen, device=dev)
    n = COUNT.launches
    got = ams_matmul_fp533(x, pw.hi, pw.scale)
    torch.cuda.synchronize()
    assert COUNT.launches == n + 1
    want = ams_matmul_fp533_plain(x, pw.hi, pw.scale)
    # same exact products, f32 sums in another order
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("K,N,B", [(700, 520, 200), (2560, 288, 8), (3584, 3584, 128)])
def test_k1_planned_shapes_match_plain(K, N, B):
    """K1 over two row tiles (B = 200), ragged 64-column tiles (N = 520), the
    32-column tile (MiniCPM3-4B's kv_a, N = 288) and a clustered K split at
    prefill rows; two launches give the same bits (fixed reduction order)."""
    from repro_torch.kernels.ams_matmul import ams_matmul_fp533, ams_matmul_fp533_plain
    from repro_torch.kernels.tuning import plan_ams_matmul

    dev = cuda_device()
    pw, gen = packed(K, N, dev, seed=K + N + B)
    x = torch.zeros((B, pw.hi.shape[0] * 6), device=dev)
    x[:, :K] = torch.randn((B, K), generator=gen, device=dev)
    plan = plan_ams_matmul(B, pw.hi.shape[0], N)
    assert plan.cluster > 1 or plan.row_tiles > 1
    got = ams_matmul_fp533(x, pw.hi, pw.scale)
    again = ams_matmul_fp533(x, pw.hi, pw.scale)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = ams_matmul_fp533_plain(x, pw.hi, pw.scale)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", [(3584, 3584), (3584, 512), (18944, 3584)])
def test_k1_row_bits_do_not_depend_on_the_rows(K, N):
    """A row of x gets the same bits from K1 at every row count (1 to 256
    rows: every row tile height, two row tiles): the K split and each
    row's order of sums do not follow the rows."""
    from repro_torch.kernels.ams_matmul import ams_matmul_fp533

    dev = cuda_device()
    pw, gen = packed(K, N, dev, seed=K + N)
    x = torch.zeros((256, pw.hi.shape[0] * 6), device=dev)
    x[:, :K] = torch.randn((256, K), generator=gen, device=dev)
    one = ams_matmul_fp533(x[:1], pw.hi, pw.scale)
    for B in (2, 8, 10, 16, 40, 64, 128, 256):
        assert torch.equal(ams_matmul_fp533(x[:B], pw.hi, pw.scale)[:1], one), B


@pytest.mark.gpu
@pytest.mark.parametrize("width", [3584, 152064])
def test_row_sum_bits_do_not_depend_on_the_rows(width):
    """`models.common.row_sum` (the norm's mean square, the sampling
    softmax's sums) and `rms_norm` give every row the same bits at any row
    count and place among the rows."""
    from repro_torch.models.common import rms_norm, row_sum

    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(width)
    x = 20 * torch.randn((40, width), generator=gen, device=dev)
    x = x * torch.exp(torch.randn((40, width), generator=gen, device=dev))
    g = torch.rand(width, generator=gen, device=dev) + 0.5
    for fn in (row_sum, lambda t: rms_norm(t, g)):
        alone = [fn(x[r:r + 1]) for r in range(40)]
        for n in (2, 4, 8, 10, 40):
            y = fn(x[:n])
            assert all(torch.equal(y[r], alone[r][0]) for r in range(n)), n


@pytest.mark.gpu
def test_k1_identity_is_bit_exact():
    from repro_torch.kernels import ops, ref

    dev = cuda_device()
    pw, _ = packed(384, 128, dev, seed=16)
    eye = torch.eye(8, 384, device=dev)
    assert torch.equal(ops.ams_matmul(eye, pw), ref.dequant_full(pw)[:8])


PLANES_SCHEMES = ("fp8", "fp6-e2m3", "fp6-e3m2", "fp5-e2m2", "fp4.5-e2m2", "fp4.33-e2m2",
                  "fp4.25-e2m2", "fp4-e2m1")


def _k1b_case(scheme, K, N, B, dev):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ams_matmul import COUNT_PLANES, ams_matmul_planes_plain

    pw, gen = packed(K, N, dev, seed=K + N, scheme=scheme)
    x = torch.randn((B, K), generator=gen, device=dev)
    n = COUNT_PLANES.launches
    got = ops.ams_matmul(x, pw)
    torch.cuda.synchronize()
    assert COUNT_PLANES.launches == n + 1
    Kp = pw.layout.padded_k(K)
    want = ams_matmul_planes_plain(torch.nn.functional.pad(x, (0, Kp - K)), pw.hi,
                                   pw.lsb, pw.scale, pw.layout)
    # same exact products, f32 sums in another order
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", PLANES_SCHEMES)
def test_k1b_kernel_matches_plain_every_scheme(scheme):
    _k1b_case(scheme, 700, 300, 5, cuda_device())


@pytest.mark.gpu
@pytest.mark.parametrize("K,N,B", [(3584, 3584, 8), (3584, 512, 128), (3584, 18944, 8),
                                   (18944, 3584, 128), (1, 40, 2),
                                   # MusicGen-medium's MHA and GELU MLP
                                   (1536, 1536, 8), (1536, 6144, 8), (6144, 1536, 128)])
def test_k1b_fp425_kernel_matches_plain(K, N, B):
    _k1b_case("fp4.25-e2m2", K, N, B, cuda_device())


QWEN_PROJ = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584)]


@pytest.mark.gpu
@pytest.mark.parametrize("scheme,K,N,B", [
    ("fp4.25-e2m2", 3584, 3584, 8), ("fp4.25-e2m2", 3584, 512, 8),
    ("fp4.25-e2m2", 3584, 18944, 8), ("fp4.25-e2m2", 18944, 3584, 8),
    ("fp4.25-e2m2", 3584, 3584, 128), ("fp4.25-e2m2", 3584, 512, 128),
    ("fp4.25-e2m2", 3584, 18944, 128), ("fp4.25-e2m2", 18944, 3584, 128),
    ("fp4.25-e2m2", 700, 520, 200), ("fp4.33-e2m2", 3584, 3584, 8),
    ("fp4.33-e2m2", 2560, 288, 33), ("fp4.5-e2m2", 3584, 520, 16), ("fp4-e2m1", 3584, 3584, 8)]
    + [(sc, K, N, B) for sc in ("fp8", "fp6-e2m3", "fp5-e2m2") for B in (8, 128)
       for K, N in QWEN_PROJ]
    + [("fp6-e2m3", 700, 520, 200), ("fp6-e3m2", 2560, 288, 33), ("fp8", 3584, 520, 16)])
def test_k1b_planned_shapes_match_plain(scheme, K, N, B):
    """K1b on the tensor cores at every Qwen2-7B projection shape at B = 8
    and 128 (fp4.25, fp8, fp6-e2m3, fp5-e2m2), two row tiles (B = 200),
    ragged 64-column tiles (N = 520), the 32-column tile (N = 288), and the
    other schemes (fp4.33: k-groups across lsb rows and a ragged last
    k-group); two launches give the same bits (fixed reduction order)."""
    from repro_torch.kernels.ams_matmul import (
        ams_matmul_planes,
        ams_matmul_planes_plain,
        planes_on_tensor_cores,
    )

    dev = cuda_device()
    pw, gen = packed(K, N, dev, seed=K + N + B, scheme=scheme)
    assert planes_on_tensor_cores(pw.layout)
    x = torch.zeros((B, pw.hi.shape[0] * pw.layout.per_word), device=dev)
    x[:, :K] = torch.randn((B, K), generator=gen, device=dev)
    got = ams_matmul_planes(x, pw.hi, pw.lsb, pw.scale, pw.layout)
    again = ams_matmul_planes(x, pw.hi, pw.lsb, pw.scale, pw.layout)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = ams_matmul_planes_plain(x, pw.hi, pw.lsb, pw.scale, pw.layout)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["fp4.25-e2m2", "fp8", "fp6-e3m2", "fp4.5-e2m2",
                                    "fp4.33-e2m2", "fp4-e2m1", "fp6-e2m3", "fp5-e2m2"])
def test_k1b_identity_is_bit_exact(scheme):
    from repro_torch.kernels import ops, ref

    dev = cuda_device()
    pw, _ = packed(384, 128, dev, seed=16, scheme=scheme)
    eye = torch.eye(8, 384, device=dev)
    assert torch.equal(ops.ams_matmul(eye, pw), ref.dequant_full(pw)[:8])


def _wide_planes():
    """(name, AMSFormat) of every base format and k <= 4 whose planes have
    per_word 4, 5 or 6 (fp8, fp6, fp5, fp5.33 as planes, e4m3 k = 2, e3m3
    k = 3, ...)."""
    from repro_torch.core.formats import FORMATS, AMSFormat
    from repro_torch.core.packing import make_layout

    return [(f"{n}-k{k}", AMSFormat(f, k)) for n, f in FORMATS.items() for k in range(1, 5)
            if make_layout(AMSFormat(f, k), "planes").per_word in (4, 5, 6)]


WIDE_PLANES = _wide_planes()


@pytest.mark.gpu
@pytest.mark.parametrize("name,sc", WIDE_PLANES, ids=[n for n, _ in WIDE_PLANES])
def test_k1b_wide_layouts_match_plain(name, sc):
    """Every per_word 4 / 5 / 6 layout through its decode hook: against the
    plain version at a ragged shape (K = 700, N = 300, B = 5) and over a
    cluster split with two row tiles (K = 2000, N = 520, B = 200); an
    identity weight bit-exact."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ams_matmul import ams_matmul_planes, ams_matmul_planes_plain

    dev = cuda_device()
    for K, N, B in ((700, 300, 5), (2000, 520, 200)):
        pw, gen = packed(K, N, dev, seed=K + N + B, scheme=sc, container="planes")
        x = torch.zeros((B, pw.hi.shape[0] * pw.layout.per_word), device=dev)
        x[:, :K] = torch.randn((B, K), generator=gen, device=dev)
        got = ams_matmul_planes(x, pw.hi, pw.lsb, pw.scale, pw.layout)
        want = ams_matmul_planes_plain(x, pw.hi, pw.lsb, pw.scale, pw.layout)
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), (K, N, B)
    pw, _ = packed(384, 128, dev, seed=16, scheme=sc, container="planes")
    eye = torch.eye(8, 384, device=dev)
    assert torch.equal(ops.ams_matmul(eye, pw), ref.dequant_full(pw)[:8])


@pytest.mark.gpu
@pytest.mark.parametrize("scheme,K", [("fp6-e2m3", 3584), ("fp5-e2m2", 700), ("fp8", 700),
                                      ("fp4.25-e2m2", 700)])
def test_k1b_reads_x_rows_only_up_to_kp(scheme, K):
    """x as bf16 rows of a wider buffer (a view, stride a multiple of 8)
    whose columns past Kp hold NaN: the kernel takes the view as it is and
    reads no column past Kp (the copy that runs past it zero-fills), so
    the result equals the plain version's on x[:, :Kp]."""
    from repro_torch.kernels.ams_matmul import ams_matmul_planes, ams_matmul_planes_plain

    dev = cuda_device()
    pw, gen = packed(K, 520, dev, seed=K, scheme=scheme)
    Kp = pw.hi.shape[0] * pw.layout.per_word
    wide = torch.full((9, -(-Kp // 8) * 8 + 8), float("nan"), dtype=torch.bfloat16, device=dev)
    wide[:, :Kp] = 0
    wide[:, :K] = torch.randn((9, K), generator=gen, device=dev).to(torch.bfloat16)
    x = wide[:, :Kp]
    got = ams_matmul_planes(x, pw.hi, pw.lsb, pw.scale, pw.layout)
    want = ams_matmul_planes_plain(x, pw.hi, pw.lsb, pw.scale, pw.layout)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["fp8", "fp6-e2m3", "fp5-e2m2"])
def test_k1b_launches_once_per_call_without_plain(scheme):
    """One launch per call on CUDA tensors and no call of the plain version,
    through the layer wrapper (x of K columns, padded by the wrapper)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ams_matmul import COUNT_PLANES

    dev = cuda_device()
    pw, gen = packed(3584, 512, dev, seed=3, scheme=scheme)
    x = torch.randn((8, 3584), generator=gen, device=dev)
    n, plain = COUNT_PLANES.launches, COUNT_PLANES.plain_on_cuda
    for _ in range(3):
        ops.ams_matmul(x, pw)
    torch.cuda.synchronize()
    assert COUNT_PLANES.launches == n + 3 and COUNT_PLANES.plain_on_cuda == plain


# pages the paged kernels walk in 2 (48: the second ragged), 4 and 10
# sub-tiles of 32 tokens (300: the scores of the last two, past the 256 a
# warp keeps, recomputed in the second pass), at Qwen2-7B's widths and a
# narrow odd head
WIDE_PAGES = [(4, 7, 128, 48, 1), (4, 7, 128, 64, 1), (4, 7, 128, 64, 16),
              (4, 7, 128, 128, 1), (4, 7, 128, 128, 16), (4, 7, 128, 300, 1),
              (1, 3, 7, 48, 2), (1, 3, 7, 300, 2)]


def _paged_case(kv, g, hd, page, chunk, dev, gen):
    """Block table over 4 slots x 8 pages, lengths with a full slot, a
    short one, an idle one and a ragged one; q folded as the template does."""
    from repro_torch.kernels.attention_template import _fold_q

    B, MP = 4, 8
    bt = torch.randperm(B * MP, generator=gen, device=dev).to(torch.int32).reshape(B, MP)
    ends = torch.tensor([MP * page, 5, 0, 3 * page + 1])         # slot 2 idle
    j = torch.arange(chunk)
    nvalid = torch.clamp(torch.tensor([chunk, chunk - 1, 0, 1]), min=0)
    nvalid = torch.minimum(nvalid, ends)
    lengths = torch.where(j[None] < nvalid[:, None], ends[:, None] - nvalid[:, None] + j + 1, 0)
    q = torch.randn((B, chunk, kv * g, hd), generator=gen, device=dev).to(torch.bfloat16)
    qf, lens, _, _ = _fold_q(q, lengths.to(dev), kv, None)
    masked = (lengths == 0).repeat_interleave(g, dim=1).to(dev)   # [B, c*g] rows
    return qf, lens, bt, masked


# K3's own cases: pages of 4 (one rank: a slot holds one 32-token tile), 48
# at chunk 16, 300 at chunk 16 over 8 kv heads (8 ranks whose score buffers
# hold 320 keys: one segment of eight pages, pages split between the
# ranks), and 4608, wider than the 4096 tokens 8 ranks' buffers hold
# (each page walked in two segments, its rest scanned for its max first)
K3_PAGES = [(1, 3, 7, 4, 1), (4, 7, 128, 4, 16), (4, 7, 128, 48, 16), (8, 7, 64, 300, 16),
            (8, 7, 64, 16, 16), (1, 3, 7, 4608, 2), (4, 7, 128, 4608, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("kv,g,hd,page,chunk", [(2, 2, 32, 8, 1), (2, 2, 32, 8, 4),
                                                (4, 7, 128, 16, 1), (4, 7, 128, 16, 16),
                                                (1, 3, 7, 8, 2), *WIDE_PAGES, *K3_PAGES])
def test_k3_kernel_matches_plain(kv, g, hd, page, chunk):
    """K3 against its plain version at pages of 4 to 300 tokens, chunks 1 to
    16, Qwen2-7B's widths and narrow odd heads, where the plan splits a
    tile's tokens over 1, 2 and 8 ranks
    (`test_k3_card_cases_take_one_two_and_eight_ranks`)."""
    from repro_torch.kernels.attention_template import (
        COUNT_BF16,
        paged_attention_bf16,
        paged_attention_bf16_plain,
    )

    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(hd + chunk + 1)
    pool = {n: torch.randn((32, page, kv, hd), generator=gen, device=dev).to(torch.bfloat16)
            for n in ("k", "v")}
    qf, lens, bt, masked = _paged_case(kv, g, hd, page, chunk, dev, gen)
    kw = dict(page_size=page, c=chunk, g=g)
    n = COUNT_BF16.launches
    got = paged_attention_bf16(qf, pool, lens, bt, **kw)
    torch.cuda.synchronize()
    assert COUNT_BF16.launches == n + 1
    want = paged_attention_bf16_plain(qf, pool, lens, bt, **kw)
    # p is rounded to bf16 in both; scores summed in another order can put
    # p one bf16 ulp (2^-8) apart, moving the output by at most 2^-8 max|v|
    tol = 2 ** -8 * float(pool["v"].float().abs().max()) + 1e-4 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert bool((got.permute(0, 2, 1, 3)[masked] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kv,g,hd,page,chunk", [(2, 2, 32, 8, 1), (2, 2, 32, 8, 4),
                                                (4, 7, 128, 16, 1), (4, 7, 128, 16, 16),
                                                (1, 3, 7, 8, 2), *WIDE_PAGES,
                                                # InternVL2-1B (g 7), MusicGen-medium (g 1)
                                                (2, 7, 64, 16, 1), (2, 7, 64, 16, 16),
                                                (24, 1, 64, 16, 1), (24, 1, 64, 16, 16)])
def test_k2_kernel_matches_plain(kv, g, hd, page, chunk):
    from repro_torch.core.formats import get_scheme
    from repro_torch.core.kv_quant import quantize_kv
    from repro_torch.kernels.attention_template import (
        COUNT,
        paged_attention_ams,
        paged_attention_ams_plain,
    )

    dev = cuda_device()
    scheme = get_scheme("fp4.25-e2m2")
    gen = torch.Generator(device=dev).manual_seed(hd + chunk)
    pool = {n: {k: t.contiguous() for k, t in quantize_kv(
        torch.randn((32, page, kv, hd), generator=gen, device=dev), scheme).items()}
        for n in ("k", "v")}
    qf, lens, bt, masked = _paged_case(kv, g, hd, page, chunk, dev, gen)
    kw = dict(page_size=page, scheme=scheme, c=chunk, g=g)
    n = COUNT.launches
    got = paged_attention_ams(qf, pool, lens, bt, **kw)
    torch.cuda.synchronize()
    assert COUNT.launches == n + 1
    want = paged_attention_ams_plain(qf, pool, lens, bt, **kw)
    assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))
    assert bool((got.permute(0, 2, 1, 3)[masked] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("scheme,kv,g,hd,page,chunk", [
    ("fp4-e2m1", 4, 7, 128, 16, 1), ("fp4-e2m1", 2, 2, 32, 8, 4),
    ("fp4.33-e2m2", 4, 7, 128, 16, 16), ("fp5-e2m2", 1, 3, 7, 8, 2),
    ("fp4-e2m1", 4, 7, 128, 48, 16), ("fp4-e2m1", 4, 7, 128, 128, 1),
    ("fp4.5-e2m2", 4, 7, 128, 16, 1), ("fp4.5-e2m2", 4, 7, 128, 64, 16),
    ("fp4.33-e2m2", 4, 7, 128, 48, 1), ("fp4.33-e2m2", 4, 7, 128, 128, 16),
    ("fp4.33-e2m2", 1, 3, 7, 64, 2)])
def test_k2_kernel_matches_plain_on_other_schemes(scheme, kv, g, hd, page, chunk):
    """K2 over AMS pages of e2m1 codes (k = 1: the LSB plane holds each
    code's mantissa bit) and of e2m2 codes shared by k = 2, 3 and 1, at
    Qwen2-7B's widths over pages of 16 to 128 tokens (fp4.33's rows of 66
    hi bytes are copied byte by byte: not 16-byte aligned)."""
    from repro_torch.core.formats import get_scheme
    from repro_torch.core.kv_quant import quantize_kv
    from repro_torch.kernels.attention_template import (
        COUNT,
        paged_attention_ams,
        paged_attention_ams_plain,
    )

    dev = cuda_device()
    scheme = get_scheme(scheme)
    gen = torch.Generator(device=dev).manual_seed(hd + chunk + 4)
    pool = {n: {k: t.contiguous() for k, t in quantize_kv(
        torch.randn((32, page, kv, hd), generator=gen, device=dev), scheme).items()}
        for n in ("k", "v")}
    qf, lens, bt, masked = _paged_case(kv, g, hd, page, chunk, dev, gen)
    kw = dict(page_size=page, scheme=scheme, c=chunk, g=g)
    n = COUNT.launches
    got = paged_attention_ams(qf, pool, lens, bt, **kw)
    torch.cuda.synchronize()
    assert COUNT.launches == n + 1
    want = paged_attention_ams_plain(qf, pool, lens, bt, **kw)
    assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))
    assert bool((got.permute(0, 2, 1, 3)[masked] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("page,chunk", [(16, 1), (16, 16), (128, 1), (128, 16)])
def test_k2_is_deterministic(page, chunk):
    """The ranks' (m, l, acc) merge in a fixed rank order: two launches at
    Qwen2-7B shapes (8 slots, lengths up to 1024) give the same bits."""
    from repro_torch.core.formats import get_scheme
    from repro_torch.core.kv_quant import quantize_kv
    from repro_torch.kernels.attention_template import COUNT, _fold_q, paged_attention_ams
    from repro_torch.kernels.tuning import plan_paged_attention

    dev = cuda_device()
    scheme = get_scheme("fp4.25-e2m2")
    gen = torch.Generator(device=dev).manual_seed(50 + page + chunk)
    MP, B = 1024 // page, 8
    pool = {n: {k: t.contiguous() for k, t in quantize_kv(
        torch.randn((B * MP, page, 4, 128), generator=gen, device=dev), scheme).items()}
        for n in ("k", "v")}
    bt = torch.randperm(B * MP, generator=gen, device=dev).to(torch.int32).reshape(B, MP)
    ends = torch.tensor([1024, 700, 1, 0, 513, 1000, 64, 999])
    lengths = torch.clamp(ends[:, None] - chunk + 1 + torch.arange(chunk)[None], min=0)
    q = torch.randn((B, chunk, 28, 128), generator=gen, device=dev).to(torch.bfloat16)
    qf, lens, _, _ = _fold_q(q, lengths.to(dev), 4, None)
    assert plan_paged_attention(B, 4, 7 * chunk, 1024).cluster > 1
    kw = dict(page_size=page, scheme=scheme, c=chunk, g=7)
    n = COUNT.launches
    a = paged_attention_ams(qf, pool, lens, bt, **kw)
    b = paged_attention_ams(qf, pool, lens, bt, **kw)
    torch.cuda.synchronize()
    assert COUNT.launches == n + 2 and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("page", [16, 128])
def test_k2_row_bits_do_not_depend_on_the_tile(page):
    """Each row of a chunk gets the same bits from K2 as its query alone
    (decode width), at lengths whose chunk crosses a share boundary (255
    takes shares of 32 tokens, 259 of 64) and in tiles of 8 and 16 rows,
    for any slot count."""
    from repro_torch.core.formats import get_scheme
    from repro_torch.core.kv_quant import quantize_kv
    from repro_torch.kernels.attention_template import _fold_q, paged_attention_ams

    dev = cuda_device()
    scheme = get_scheme("fp4.25-e2m2")
    gen = torch.Generator(device=dev).manual_seed(70 + page)
    MP, B = 1024 // page, 4
    pool = {n: {k: t.contiguous() for k, t in quantize_kv(
        torch.randn((B * MP, page, 4, 128), generator=gen, device=dev), scheme).items()}
        for n in ("k", "v")}
    bt = torch.randperm(B * MP, generator=gen, device=dev).to(torch.int32).reshape(B, MP)
    ends = torch.tensor([255, 250, 1000, 32])
    for chunk in (5, 16):
        lengths = ends[:, None] + torch.arange(chunk)[None]
        q = torch.randn((B, chunk, 28, 128), generator=gen, device=dev).to(torch.bfloat16)
        qf, lens, _, _ = _fold_q(q, lengths.to(dev), 4, None)
        kw = dict(page_size=page, scheme=scheme, g=7)
        wide = paged_attention_ams(qf, pool, lens, bt, c=chunk, **kw)       # [B, kv, c*g, hd]
        for j in range(chunk):
            qj, lj, _, _ = _fold_q(q[:, j:j + 1].contiguous(), lengths[:, j:j + 1].to(dev), 4,
                                   None)
            for nb in (1, B):
                alone = paged_attention_ams(qj[:nb], pool, lj[:nb], bt[:nb], c=1, **kw)
                assert torch.equal(wide[:nb, :, 7 * j:7 * j + 7], alone), (chunk, j, nb)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["k3", "k4", "k5"])
def test_attention_row_bits_do_not_depend_on_the_tile(kernel):
    """K3 (bf16 pages of 16), K4 (contiguous GQA) and K5 (the MLA stream):
    each row of a chunk of 5 or 16 queries gets the same bits as its query
    alone, at 1 and 4 slots, at lengths whose chunk crosses a 32-key tile
    and where the other slots are shorter or longer (the split of a row's
    keys follows the block table or the reference's block, never the
    tile's longest row, B or the row tiles; the reference's block is the
    same at these widths)."""
    from repro_torch.kernels.attention_template import (
        fused_contiguous_attention,
        fused_paged_attention,
    )

    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(80)
    B, S, page = 4, 1024, 16
    kv, H, hd, hd_v = (1, 40, 288, 256) if kernel == "k5" else (4, 28, 128, 128)
    ends = torch.tensor([255, 250, 1000, 32])
    if kernel == "k3":
        MP = S // page
        pool = {n: torch.randn((B * MP, page, kv, hd), generator=gen, device=dev).to(
            torch.bfloat16) for n in ("k", "v")}
        bt = torch.randperm(B * MP, generator=gen, device=dev).to(torch.int32).reshape(B, MP)

        def call(q, lengths, nb):
            return fused_paged_attention(q, pool, lengths, bt[:nb], page_size=page,
                                         kv_scheme=None)
    else:
        kc = torch.randn((B, S, kv, hd), generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn((B, S, kv, hd_v), generator=gen, device=dev).to(torch.bfloat16)

        def call(q, lengths, nb):
            if kernel == "k4":
                return fused_contiguous_attention(q, kc[:nb], lengths, v_cache=vc[:nb],
                                                  block_kv=S)
            return fused_contiguous_attention(q, kc[:nb], lengths, value_slice=hd_v,
                                              block_kv=S, scale=0.1)
    for chunk in (5, 16):
        lengths = (ends[:, None] + torch.arange(chunk)[None]).to(dev)
        q = torch.randn((B, chunk, H, hd), generator=gen, device=dev).to(torch.bfloat16)
        wide = call(q, lengths, B)
        for j in range(chunk):
            for nb in (1, B):
                alone = call(q[:nb, j:j + 1].contiguous(), lengths[:nb, j:j + 1].contiguous(),
                             nb)
                assert torch.equal(wide[:nb, j:j + 1], alone), (kernel, chunk, j, nb)


def test_k3_card_cases_take_one_two_and_eight_ranks():
    """The shapes of `test_k3_kernel_matches_plain` (4 slots x 8 pages) give
    K3's plan clusters of 1, 2 and 8 ranks, more than one segment, and
    pages wider than a segment."""
    from repro_torch.kernels.tuning import paged_segments, plan_paged_bf16_attention

    cases = [(2, 2, 32, 8, 1), (4, 7, 128, 16, 1), *WIDE_PAGES, *K3_PAGES]
    plans = {c: plan_paged_bf16_attention(4, c[0], c[1] * c[4], 8 * c[3], c[3]) for c in cases}
    assert {1, 2, 8} <= {p.cluster for p in plans.values()}
    assert max(len(paged_segments(8 * c[3], c[3], p.cluster, p.score_keys))
               for c, p in plans.items()) > 1
    assert any(c[3] > p.cluster * p.score_keys for c, p in plans.items())


@pytest.mark.gpu
@pytest.mark.parametrize("page,chunk", [(16, 1), (16, 16), (128, 1), (128, 16)])
def test_k3_is_deterministic(page, chunk):
    """The ranks' (m, l, acc) merge in a fixed rank order: two launches at
    Qwen2-7B shapes (8 slots, lengths up to 1024) give the same bits."""
    from repro_torch.kernels.attention_template import COUNT_BF16, _fold_q, paged_attention_bf16
    from repro_torch.kernels.tuning import plan_paged_bf16_attention

    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(60 + page + chunk)
    MP, B = 1024 // page, 8
    pool = {n: torch.randn((B * MP, page, 4, 128), generator=gen, device=dev).to(torch.bfloat16)
            for n in ("k", "v")}
    bt = torch.randperm(B * MP, generator=gen, device=dev).to(torch.int32).reshape(B, MP)
    ends = torch.tensor([1024, 700, 1, 0, 513, 1000, 64, 999])
    lengths = torch.clamp(ends[:, None] - chunk + 1 + torch.arange(chunk)[None], min=0)
    q = torch.randn((B, chunk, 28, 128), generator=gen, device=dev).to(torch.bfloat16)
    qf, lens, _, _ = _fold_q(q, lengths.to(dev), 4, None)
    assert plan_paged_bf16_attention(B, 4, 7 * chunk, 1024, page).cluster > 1
    kw = dict(page_size=page, c=chunk, g=7)
    n = COUNT_BF16.launches
    a = paged_attention_bf16(qf, pool, lens, bt, **kw)
    b = paged_attention_bf16(qf, pool, lens, bt, **kw)
    torch.cuda.synchronize()
    assert COUNT_BF16.launches == n + 2 and torch.equal(a, b)


def _stream_pool(kind, page, hd, dev, gen):
    """A K5p stream pool of 32 pages, kv = 1: bf16 pages, or AMS-e2m2 planes
    (fp4.25-e2m2, the CacheConfig default) with only the ``k`` leaf."""
    from repro_torch.core.formats import get_scheme
    from repro_torch.core.kv_quant import quantize_kv

    x = torch.randn((32, page, 1, hd), generator=gen, device=dev)
    if kind == "bf16":
        return {"k": x.to(torch.bfloat16)}
    return {"k": {k: t.contiguous()
                  for k, t in quantize_kv(x, get_scheme("fp4.25-e2m2")).items()}}


@pytest.mark.gpu
@pytest.mark.parametrize("hd,hd_v,g", [(72, 64, 4), (288, 256, 40)])
@pytest.mark.parametrize("page", [4, 8, 16, 32, 48, 64, 128, 300, 1100])
@pytest.mark.parametrize("chunk", [1, 16])
@pytest.mark.parametrize("kind", ["bf16", "ams"])
def test_k5p_kernel_matches_plain(kind, chunk, page, hd, hd_v, g):
    """K5p, the paged absorbed-MLA stream, against its plain version: AMS
    pages within 1e-4 of max |y| (f32 order), bf16 pages within K3's rule
    (p rounded to bf16 in both; a score summed in another order can put p
    one bf16 ulp apart, moving the output by at most 2^-8 max|v|). Over 4
    slots x 8 pages the plan takes 1 rank at pages of 4, 2 at 8 and 8 from
    16 on; pages of 300 take three segments (on bf16 pages of three whole
    pages each); bf16 pages of 1100, wider than 8 ranks' 128 keys each,
    take three segments each, their rest scanned for the page's max
    first."""
    from repro_torch.core.formats import get_scheme
    from repro_torch.kernels import attention_template as T

    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(hd + chunk + page)
    pool = _stream_pool(kind, page, hd, dev, gen)
    qf, lens, bt, masked = _paged_case(1, g, hd, page, chunk, dev, gen)
    kw = dict(page_size=page, c=chunk, g=g, hd_v=hd_v)
    if kind == "bf16":
        kernel, plain, count = (T.paged_attention_stream_bf16,
                                T.paged_attention_stream_bf16_plain, T.COUNT_STREAM_BF16)
    else:
        kw["scheme"] = get_scheme("fp4.25-e2m2")
        kernel, plain, count = (T.paged_attention_stream_ams,
                                T.paged_attention_stream_ams_plain, T.COUNT_STREAM_AMS)
    n = count.launches
    got = kernel(qf, pool, lens, bt, **kw)
    torch.cuda.synchronize()
    assert count.launches == n + 1 and got.shape == (4, 1, chunk * g, hd_v)
    want = plain(qf, pool, lens, bt, **kw)
    if kind == "bf16":
        vmax = float(pool["k"][..., :hd_v].float().abs().max())
        tol = 2 ** -8 * vmax + 1e-4 * float(want.abs().max())
    else:
        tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    assert bool((got.permute(0, 2, 1, 3)[masked] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("scheme,page,chunk", [("fp4-e2m1", 16, 1), ("fp4-e2m1", 48, 16),
                                               ("fp4.33-e2m2", 16, 16), ("fp4.5-e2m2", 64, 1)])
@pytest.mark.parametrize("hd,hd_v,g", [(72, 64, 4), (288, 256, 40)])
def test_k5p_kernel_matches_plain_on_other_schemes(scheme, page, chunk, hd, hd_v, g):
    """K5p over AMS pages of e2m1 codes (k = 1: the LSB plane holds each
    code's mantissa bit) and of e2m2 codes shared by k = 3 and 2, within
    1e-4 of max |y| of its plain version."""
    from repro_torch.core.formats import get_scheme
    from repro_torch.core.kv_quant import quantize_kv
    from repro_torch.kernels import attention_template as T

    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(hd + chunk + page + 3)
    sch = get_scheme(scheme)
    pool = {"k": {k: t.contiguous() for k, t in quantize_kv(
        torch.randn((32, page, 1, hd), generator=gen, device=dev), sch).items()}}
    qf, lens, bt, masked = _paged_case(1, g, hd, page, chunk, dev, gen)
    kw = dict(page_size=page, c=chunk, g=g, hd_v=hd_v, scheme=sch)
    n = T.COUNT_STREAM_AMS.launches
    got = T.paged_attention_stream_ams(qf, pool, lens, bt, **kw)
    torch.cuda.synchronize()
    assert T.COUNT_STREAM_AMS.launches == n + 1
    want = T.paged_attention_stream_ams_plain(qf, pool, lens, bt, **kw)
    assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))
    assert bool((got.permute(0, 2, 1, 3)[masked] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "ams"])
@pytest.mark.parametrize("page,chunk", [(16, 1), (16, 16), (128, 1), (128, 16)])
def test_k5p_is_deterministic(kind, page, chunk):
    """The ranks' (m, l, acc) merge in a fixed rank order: two launches at
    MiniCPM3-4B's widths (8 slots, lengths up to 1024) give the same bits."""
    from repro_torch.core.formats import get_scheme
    from repro_torch.kernels import attention_template as T
    from repro_torch.kernels.tuning import plan_paged_mla_attention

    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(70 + page + chunk)
    MP, B = 1024 // page, 8
    x = torch.randn((B * MP, page, 1, 288), generator=gen, device=dev)
    if kind == "bf16":
        pool, fn, count = {"k": x.to(torch.bfloat16)}, T.paged_attention_stream_bf16, \
            T.COUNT_STREAM_BF16
        kw = {}
    else:
        from repro_torch.core.kv_quant import quantize_kv

        scheme = get_scheme("fp4.25-e2m2")
        pool = {"k": {k: t.contiguous() for k, t in quantize_kv(x, scheme).items()}}
        fn, count, kw = T.paged_attention_stream_ams, T.COUNT_STREAM_AMS, dict(scheme=scheme)
    bt = torch.randperm(B * MP, generator=gen, device=dev).to(torch.int32).reshape(B, MP)
    ends = torch.tensor([1024, 700, 1, 0, 513, 1000, 64, 999])
    lengths = torch.clamp(ends[:, None] - chunk + 1 + torch.arange(chunk)[None], min=0)
    q = torch.randn((B, chunk, 40, 288), generator=gen, device=dev).to(torch.bfloat16)
    qf, lens, _, _ = T._fold_q(q, lengths.to(dev), 1, 1 / math.sqrt(96))
    assert plan_paged_mla_attention(B, 1, 40 * chunk, 1024).cluster > 1
    kw.update(page_size=page, c=chunk, g=40, hd_v=256)
    n = count.launches
    a = fn(qf, pool, lens, bt, **kw)
    b = fn(qf, pool, lens, bt, **kw)
    torch.cuda.synchronize()
    assert count.launches == n + 2 and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "ams"])
@pytest.mark.parametrize("hd,hd_v,page", [(320, 256, 16), (288, 264, 16)])
def test_k5p_raises_past_its_widths(kind, hd, hd_v, page):
    """K5p takes hd <= 288 and value_slice <= 256 (MiniCPM3-4B's stream),
    pages of any size (the page-64 case that raised before is now matched
    against the plain version in test_k5p_kernel_matches_plain): past those
    widths the wrapper raises instead of launching or falling back to the
    plain version."""
    from repro_torch.core.formats import get_scheme
    from repro_torch.kernels import attention_template as T

    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(2)
    pool = _stream_pool(kind, page, hd, dev, gen)
    qf, lens, bt, _ = _paged_case(1, 2, hd, page, 1, dev, gen)
    kw = dict(page_size=page, c=1, g=2, hd_v=hd_v)
    if kind == "bf16":
        fn, count = T.paged_attention_stream_bf16, T.COUNT_STREAM_BF16
    else:
        fn, count = T.paged_attention_stream_ams, T.COUNT_STREAM_AMS
        kw["scheme"] = get_scheme("fp4.25-e2m2")
    n, plain = count.launches, count.plain_on_cuda
    with pytest.raises(NotImplementedError, match="K5p takes"):
        fn(qf, pool, lens, bt, **kw)
    assert (count.launches, count.plain_on_cuda) == (n, plain)


def _contiguous_case(kv, g, hd, S, chunk, dev, gen):
    """4 slots over a [4, S] cache: a full slot, a short one, an idle one and
    a ragged one; q folded as the template does."""
    from repro_torch.kernels.attention_template import _fold_q

    ends = torch.tensor([S, 5, 0, S // 2 + 1])                  # slot 2 idle
    j = torch.arange(chunk)
    nvalid = torch.minimum(torch.clamp(torch.tensor([chunk, chunk - 1, 0, 1]), min=0), ends)
    lengths = torch.where(j[None] < nvalid[:, None], ends[:, None] - nvalid[:, None] + j + 1, 0)
    q = torch.randn((4, chunk, kv * g, hd), generator=gen, device=dev).to(torch.bfloat16)
    qf, lens, _, _ = _fold_q(q, lengths.to(dev), kv, None)
    masked = (lengths == 0).repeat_interleave(g, dim=1).to(dev)   # [B, c*g] rows
    return qf, lens, masked


def _check_contiguous(got, want, qf, k, v, lens, masked, **kw):
    """Element by element within what p's rounding allows: p is rounded to
    bf16 in both, and scores summed in another f32 order can put a p one
    bf16 ulp apart, at most 2^-7 of itself, which moves an output by at most
    2^-7 * A, A = sum_i bf16(p_i) |v_i| / l (the plain walk over |v| with
    the same p); the f32 orders of the sums stay below 1e-4 * A."""
    from repro_torch.kernels.attention_template import contiguous_attention_plain

    kw.pop("hd_v", None)
    tol = (2 ** -7 + 1e-4) * contiguous_attention_plain(qf, k, v.abs().contiguous(), lens,
                                                         **kw)
    assert bool(((got - want).abs() <= tol).all())
    assert bool((got.permute(0, 2, 1, 3)[masked] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kv,g,hd,S,chunk,block_kv", [
    (2, 2, 32, 64, 1, 64), (2, 2, 32, 64, 4, 16), (4, 7, 128, 1024, 1, 1024),
    (4, 7, 128, 1024, 16, 1024), (4, 7, 128, 1024, 16, 128), (1, 3, 7, 40, 2, 8)])
def test_k4_kernel_matches_plain(kv, g, hd, S, chunk, block_kv):
    from repro_torch.kernels.attention_template import (
        COUNT_CONTIG,
        contiguous_attention,
        contiguous_attention_plain,
    )

    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(hd + chunk + 2)
    k, v = (torch.randn((4, S, kv, hd), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    qf, lens, masked = _contiguous_case(kv, g, hd, S, chunk, dev, gen)
    kw = dict(c=chunk, g=g, block_kv=block_kv)
    n = COUNT_CONTIG.launches
    got = contiguous_attention(qf, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert COUNT_CONTIG.launches == n + 1
    _check_contiguous(got, contiguous_attention_plain(qf, k, v, lens, **kw), qf, k, v, lens,
                      masked, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("kv,g,hd,S,chunk,block_kv,fit", [
    (2, 2, 128, 16384, 1, 16384, False), (4, 7, 128, 8192, 4, 2048, True),
    (1, 3, 20, 16384, 2, 16384, False)])
def test_k4_plan_routes_match_plain(kv, g, hd, S, chunk, block_kv, fit):
    """K4's two routes: a share of 16 rows x 2048 keys does not fit in shared
    memory (the scores are recomputed in a second pass), and S = 8192 in
    blocks of 2048 keeps them (four blocks, one cluster max per block)."""
    from repro_torch.kernels.attention_template import (
        contiguous_attention,
        contiguous_attention_plain,
    )
    from repro_torch.kernels.tuning import plan_contiguous_attention

    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(S + chunk)
    k, v = (torch.randn((4, S, kv, hd), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    qf, lens, masked = _contiguous_case(kv, g, hd, S, chunk, dev, gen)
    assert plan_contiguous_attention(4, kv, chunk * g, block_kv).scores_fit == fit
    kw = dict(c=chunk, g=g, block_kv=block_kv)
    got = contiguous_attention(qf, k, v, lens, **kw)
    torch.cuda.synchronize()
    _check_contiguous(got, contiguous_attention_plain(qf, k, v, lens, **kw), qf, k, v, lens,
                      masked, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1, 4])
def test_k4_rows_shorter_than_the_split(chunk):
    """Every row sees fewer keys than the cluster has ranks, so most ranks'
    shares hold no visible key: they must add exact zeros, not NaN; two
    launches give the same bits."""
    from repro_torch.kernels.attention_template import (
        _fold_q,
        contiguous_attention,
        contiguous_attention_plain,
    )
    from repro_torch.kernels.tuning import plan_contiguous_attention

    dev = cuda_device()
    kv, g, hd, S = 4, 7, 128, 1024
    gen = torch.Generator(device=dev).manual_seed(31 + chunk)
    k, v = (torch.randn((8, S, kv, hd), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    lengths = torch.tensor([[1 + (b + j) % 3 if b != 3 else 0 for j in range(chunk)]
                            for b in range(8)])
    q = torch.randn((8, chunk, kv * g, hd), generator=gen, device=dev).to(torch.bfloat16)
    qf, lens, _, _ = _fold_q(q, lengths.to(dev), kv, None, round_scaled=False)
    assert plan_contiguous_attention(8, kv, chunk * g, S).cluster > int(lengths.max())
    kw = dict(c=chunk, g=g, block_kv=S)
    got = contiguous_attention(qf, k, v, lens, **kw)
    again = contiguous_attention(qf, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    masked = (lengths == 0).repeat_interleave(g, dim=1).to(dev)
    _check_contiguous(got, contiguous_attention_plain(qf, k, v, lens, **kw), qf, k, v, lens,
                      masked, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1, 16])
def test_k4_is_deterministic(chunk):
    """The cluster's partial sums meet in a fixed rank order: two launches at
    Qwen2-7B shapes give the same bits."""
    from repro_torch.kernels.attention_template import COUNT_CONTIG, contiguous_attention

    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(40 + chunk)
    k, v = (torch.randn((4, 1024, 4, 128), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    qf, lens, _ = _contiguous_case(4, 7, 128, 1024, chunk, dev, gen)
    kw = dict(c=chunk, g=7, block_kv=1024)
    n = COUNT_CONTIG.launches
    a = contiguous_attention(qf, k, v, lens, **kw)
    b = contiguous_attention(qf, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert COUNT_CONTIG.launches == n + 2 and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("kv,g,hd,hd_v,S,chunk,block_kv", [
    (1, 4, 48, 32, 64, 1, 64), (1, 4, 48, 32, 64, 4, 16), (1, 40, 288, 256, 1024, 1, 1024),
    (1, 40, 288, 256, 1024, 16, 1024), (1, 40, 288, 256, 1024, 16, 256),
    (2, 3, 20, 12, 40, 2, 8), (1, 40, 288, 256, 512, 1, 512), (1, 40, 288, 256, 512, 16, 512),
    (1, 40, 288, 256, 4096, 1, 4096), (1, 40, 288, 256, 4096, 4, 2048),
    (1, 13, 72, 64, 200, 4, 200)])
def test_k5_kernel_matches_plain(kv, g, hd, hd_v, S, chunk, block_kv):
    """K5 at MiniCPM3-4B's widths (decode and chunk 16 over the phase's and
    the served path's blocks; blocks of 2048 and 4096 whose shares stream
    through the ring twice) and at small ones (two row groups of 48 at 13
    heads x 4 queries), element by element within p's rounding."""
    from repro_torch.kernels.attention_template import (
        COUNT_MLA,
        contiguous_attention_mla,
        contiguous_attention_mla_plain,
    )

    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(hd + chunk + 3)
    cache = torch.randn((4, S, kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    qf, lens, masked = _contiguous_case(kv, g, hd, S, chunk, dev, gen)
    kw = dict(c=chunk, g=g, block_kv=block_kv, hd_v=hd_v)
    n = COUNT_MLA.launches
    got = contiguous_attention_mla(qf, cache, lens, **kw)
    torch.cuda.synchronize()
    assert COUNT_MLA.launches == n + 1 and got.shape == (4, kv, chunk * g, hd_v)
    _check_contiguous(got, contiguous_attention_mla_plain(qf, cache, lens, **kw), qf, cache,
                      cache[..., :hd_v], lens, masked, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1, 16])
def test_k5_is_deterministic(chunk):
    """The cluster's partial sums meet in a fixed rank order: two launches at
    MiniCPM3-4B shapes give the same bits, which also match the plain
    version."""
    from repro_torch.kernels.attention_template import (
        COUNT_MLA,
        contiguous_attention_mla,
        contiguous_attention_mla_plain,
    )

    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(68 + chunk)
    cache = torch.randn((4, 1024, 1, 288), generator=gen, device=dev).to(torch.bfloat16)
    qf, lens, masked = _contiguous_case(1, 40, 288, 1024, chunk, dev, gen)
    kw = dict(c=chunk, g=40, block_kv=1024, hd_v=256)
    n = COUNT_MLA.launches
    a = contiguous_attention_mla(qf, cache, lens, **kw)
    b = contiguous_attention_mla(qf, cache, lens, **kw)
    torch.cuda.synchronize()
    assert COUNT_MLA.launches == n + 2 and torch.equal(a, b)
    _check_contiguous(a, contiguous_attention_mla_plain(qf, cache, lens, **kw), qf, cache,
                      cache[..., :256], lens, masked, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("mla,hd,hd_v", [(False, 160, 160), (False, 136, 64),
                                         (True, 320, 256), (True, 288, 264)])
def test_contiguous_launch_raises_past_its_widths(mla, hd, hd_v):
    """K4 takes hd, hd_v <= 128 (the widest served GQA head) and K5 hd <= 288,
    hd_v <= 256 (MiniCPM3-4B's stream): wider heads make the launch fail, and
    the wrapper raises instead of falling back to the plain version."""
    from repro_torch.kernels import attention_template as T

    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(1)
    qf, lens, _ = _contiguous_case(1, 2, hd, 16, 1, dev, gen)
    k = torch.randn((4, 16, 1, hd), generator=gen, device=dev).to(torch.bfloat16)
    count = T.COUNT_MLA if mla else T.COUNT_CONTIG
    n, plain = count.launches, count.plain_on_cuda
    with pytest.raises(RuntimeError, match="launch failed"):
        if mla:
            T.contiguous_attention_mla(qf, k, lens, c=1, g=2, block_kv=16, hd_v=hd_v)
        else:
            v = torch.randn((4, 16, 1, hd_v), generator=gen, device=dev).to(torch.bfloat16)
            T.contiguous_attention(qf, k, v, lens, c=1, g=2, block_kv=16)
    assert (count.launches, count.plain_on_cuda) == (n, plain)


@pytest.mark.gpu
def test_engine_on_the_card_runs_both_kernels():
    from repro_torch.cache import CacheConfig
    from repro_torch.kernels import ams_matmul, attention_template
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine

    cuda_device()
    ams_matmul.COUNT.reset()
    attention_template.COUNT.reset()
    eng = ServeEngine(EngineConfig(reduced=True, impl="kernel", slots=2, capacity=32,
                                   prefill_chunk=4, device="cuda",
                                   cache=CacheConfig(kind="paged_ams", page_size=8,
                                                     impl="kernel")))
    hs = [eng.submit(list(range(1, 12)), 5), eng.submit(list(range(3, 9)), 4)]
    eng.run()
    assert [len(h.tokens) for h in hs] == [5, 4]
    assert ams_matmul.COUNT.launches > 0 and attention_template.COUNT.launches > 0
    assert ams_matmul.COUNT.plain_on_cuda == attention_template.COUNT.plain_on_cuda == 0


@pytest.mark.gpu
@pytest.mark.parametrize("scheme,kind", [("fp4.25-e2m2", "paged_ams"), ("fp16", "paged_bf16")])
@pytest.mark.parametrize("page", [8, 64])
def test_engine_on_the_card_new_paths(scheme, kind, page):
    """FP4.25 weights over AMS pages run K1b and K2 (K1 never launches); the
    FP16 baseline over bf16 pages runs K3 (no AMS kernel launches); pages of
    8 tokens and of 64 (walked in two sub-tiles)."""
    from repro_torch.cache import CacheConfig
    from repro_torch.kernels import ams_matmul, attention_template
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine

    cuda_device()
    counts = (ams_matmul.COUNT, ams_matmul.COUNT_PLANES, attention_template.COUNT,
              attention_template.COUNT_BF16)
    for cnt in counts:
        cnt.reset()
    eng = ServeEngine(EngineConfig(reduced=True, scheme=scheme, impl="kernel", slots=2,
                                   capacity=4 * page, prefill_chunk=4, device="cuda",
                                   cache=CacheConfig(kind=kind, page_size=page, impl="kernel")))
    hs = [eng.submit(list(range(1, 12)), 5), eng.submit(list(range(3, 9)), 4)]
    eng.run()
    assert [len(h.tokens) for h in hs] == [5, 4]
    launched = {cnt.name for cnt in counts if cnt.launches > 0}
    want = ({"ams_matmul_planes", "paged_attention_ams"} if scheme != "fp16"
            else {"paged_attention_bf16"})
    assert launched == want
    assert all(cnt.plain_on_cuda == 0 for cnt in counts)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kernel", [("qwen2-7b", "contiguous_attention"),
                                         ("minicpm3-4b", "contiguous_attention_mla")])
def test_engine_on_the_card_contiguous_paths(arch, kernel):
    """The default contiguous cache: FP5.33 weights run K1, and attention
    K4 (GQA) or K5 (the MLA stream); no other kernel launches."""
    from repro_torch.cache import CacheConfig
    from repro_torch.kernels import ams_matmul, attention_template
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine

    cuda_device()
    counts = (ams_matmul.COUNT, ams_matmul.COUNT_PLANES, attention_template.COUNT,
              attention_template.COUNT_BF16, attention_template.COUNT_CONTIG,
              attention_template.COUNT_MLA)
    for cnt in counts:
        cnt.reset()
    eng = ServeEngine(EngineConfig(arch=arch, reduced=True, impl="kernel", slots=2,
                                   capacity=32, prefill_chunk=4, device="cuda",
                                   cache=CacheConfig(impl="kernel")))
    hs = [eng.submit(list(range(1, 12)), 5), eng.submit(list(range(3, 9)), 4),
          eng.submit(list(range(5, 14)), 3)]
    eng.run()
    assert [len(h.tokens) for h in hs] == [5, 4, 3]
    assert {cnt.name for cnt in counts if cnt.launches > 0} == {"ams_matmul_fp533", kernel}
    assert all(cnt.plain_on_cuda == 0 for cnt in counts)


# ------------------------------------------------------------ graph step
# the five served paths at reduced widths: (arch, weight scheme, cache kind)
GRAPH_PATHS = {"fp5.33": ("qwen2-7b", "fp5.33-e2m3", "paged_ams"),
               "fp4.25": ("qwen2-7b", "fp4.25-e2m2", "paged_ams"),
               "fp16": ("qwen2-7b", "fp16", "paged_bf16"),
               "contig-fp5.33": ("qwen2-7b", "fp5.33-e2m3", "contiguous"),
               "mla-fp5.33": ("minicpm3-4b", "fp5.33-e2m3", "contiguous")}


def _graph_engine(path, slots=3, chunk=4, **kw):
    from repro_torch.cache import CacheConfig
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine

    arch, scheme, kind = GRAPH_PATHS[path]
    return ServeEngine(EngineConfig(arch=arch, reduced=True, scheme=scheme, impl="kernel",
                                    slots=slots, capacity=64, prefill_chunk=chunk,
                                    device="cuda", seed=3,
                                    cache=CacheConfig(kind=kind, page_size=8, impl="kernel"),
                                    **kw))


def _graph_prompts():
    # four requests on three slots: the last is admitted, and prefills, while
    # the others decode
    return [list(range(1 + i, 1 + i + n)) for i, n in enumerate((11, 6, 14, 9))]


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_graph_replays_bit_equal_to_the_eager_step(path, chunk):
    """Two engines from one seed in lockstep, one replaying its CUDA graphs,
    the other running the step function on the same static inputs: equal
    tokens after every tick, equal cache bytes at the end, a graph per
    width used (1, and the chunk when it prefills)."""
    from repro_torch.models.transformer import tree_leaves

    cuda_device()
    graphed, eager = _graph_engine(path, chunk=chunk), _graph_engine(path, chunk=chunk)
    for p in _graph_prompts():
        graphed.submit(p, 5)
        eager.submit(p, 5)
    tick = 0
    while graphed.has_work or eager.has_work:
        graphed.step()
        eager.step(eager=True)
        tick += 1
        assert ([None if r is None else r.tokens for r in graphed.active]
                == [None if r is None else r.tokens for r in eager.active]), f"tick {tick}"
    assert [r.tokens for r in graphed.finished] == [r.tokens for r in eager.finished]
    for a, b in zip(tree_leaves(graphed.cache), tree_leaves(eager.cache)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert sorted(graphed.graphs.graphs) == sorted({(1, False), (chunk, False)})
    assert eager.graphs.graphs == {}


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1, 4])
def test_graph_replays_prefix_embeds_bit_equal_to_the_eager_step(chunk):
    """The VLM path (reduced internvl2-1b, FP5.33 over AMS pages): three of
    four requests feed 8 prefix embeddings through the graphs' static
    embeds buffer; graph and eager engines in lockstep give equal tokens
    every tick and equal cache bytes."""
    import numpy as np

    from repro_torch.cache import CacheConfig
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.models.transformer import tree_leaves

    cuda_device()
    ec = EngineConfig(arch="internvl2-1b", reduced=True, scheme="fp5.33-e2m3", impl="kernel",
                      slots=3, capacity=64, prefill_chunk=chunk, device="cuda", seed=3,
                      cache=CacheConfig(kind="paged_ams", page_size=8, impl="kernel"))
    graphed, eager = ServeEngine(ec), ServeEngine(ec)
    rng = np.random.default_rng(chunk)
    for i, p in enumerate(_graph_prompts()):
        e = rng.standard_normal((8, 128)).astype(np.float32) if i != 1 else None
        graphed.submit(p, 5, prefix_embeds=e)
        eager.submit(p, 5, prefix_embeds=e)
    tick = 0
    while graphed.has_work or eager.has_work:
        graphed.step()
        eager.step(eager=True)
        tick += 1
        assert ([None if r is None else r.tokens for r in graphed.active]
                == [None if r is None else r.tokens for r in eager.active]), f"tick {tick}"
    assert [r.tokens for r in graphed.finished] == [r.tokens for r in eager.finished]
    for a, b in zip(tree_leaves(graphed.cache), tree_leaves(eager.cache)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert sorted(graphed.graphs.graphs) == sorted({(1, False), (chunk, False)})


@pytest.mark.gpu
@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_graph_replay_adds_the_captured_launch_counts(path):
    """A replay runs no wrapper: each adds what its capture recorded, the
    path's kernels and no plain version on CUDA tensors."""
    from repro_torch.kernels import ams_matmul, attention_template
    from repro_torch.kernels.build import _COUNTS

    cuda_device()
    eng = _graph_engine(path)
    for p in _graph_prompts()[:3]:
        eng.submit(p, 6)
    while (1, False) not in eng.graphs.graphs:
        eng.step()
    moved = {c.name: (n, p) for c, n, p in eng.graphs.graphs[1, False][2]}
    L = eng.cfg.num_layers
    attn = {"paged_ams": attention_template.COUNT, "paged_bf16": attention_template.COUNT_BF16}
    kind = GRAPH_PATHS[path][2]
    attn_count = attn.get(kind, attention_template.COUNT_MLA if path.startswith("mla")
                          else attention_template.COUNT_CONTIG)
    assert moved[attn_count.name] == (L, 0)
    if path != "fp16":
        mm = ams_matmul.COUNT_PLANES if path == "fp4.25" else ams_matmul.COUNT
        assert moved[mm.name][0] >= 7 * L and moved[mm.name][1] == 0
    assert all(p == 0 for _, p in moved.values())
    before = {c.name: (c.launches, c.plain_on_cuda) for c in _COUNTS}
    out = eng.step()
    assert out["generated"] == eng.active_count == 3
    after = {c.name: (c.launches, c.plain_on_cuda) for c in _COUNTS}
    for name in after:
        n, p = moved.get(name, (0, 0))
        assert after[name] == (before[name][0] + n, before[name][1] + p), name


@pytest.mark.gpu
@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_eager_step_does_not_synchronise(path):
    """After the first tick's capture (its warm-up fills the constant
    tables), the step function on the staged inputs runs under
    torch.cuda.set_sync_debug_mode("error"): no host sync, no copy from
    pageable memory."""
    from repro_torch.launch.steps import run_step

    cuda_device()
    eng = _graph_engine(path)
    for p in _graph_prompts():
        eng.submit(p, 4)
    eng.step()
    for width in (eng.step_chunk, 1):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.inputs.send()
            run_step(eng._step, eng.params, eng.cache, eng.inputs, eng.samp, width)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _feature_requests(feature):
    """Prompts and sampling of the sampled / speculative graph tests: a
    repetitive prompt the n-gram drafter can follow, a random one, and two
    of them sampled (seeded) where the feature samples."""
    from repro_torch.launch.sampling import SamplingParams

    prompts = [[5, 9, 2, 7] * 4, list(range(3, 12)), [8, 1, 8, 1, 8, 1, 6], list(range(20, 34))]
    sampled = feature in ("sampled", "both")
    samp = [SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=i) if sampled and i % 2
            else None for i in range(4)]
    return prompts, samp


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("feature", ["sampled", "speculative", "both"])
def test_sampled_and_speculative_graphs_bit_equal_to_the_eager_step(feature, chunk):
    """The sampled epilogue (threefry, masks, Gumbel draw) and the
    speculative verify with its in-step rollback replay as CUDA graphs:
    equal tokens every tick and equal cache bytes against the eager step,
    on the FP5.33 path (K1, K2), with the (width, sampled) graphs used."""
    from repro_torch.models.transformer import tree_leaves

    cuda_device()
    kw = dict(speculate_k=2) if feature != "sampled" else {}
    graphed, eager = (_graph_engine("fp5.33", chunk=chunk, **kw) for _ in range(2))
    prompts, samp = _feature_requests(feature)
    for p, sp in zip(prompts, samp):
        graphed.submit(p, 8, sampling=sp)
        eager.submit(p, 8, sampling=sp)
    tick = 0
    while graphed.has_work or eager.has_work:
        graphed.step()
        eager.step(eager=True)
        tick += 1
        assert ([None if r is None else r.tokens for r in graphed.active]
                == [None if r is None else r.tokens for r in eager.active]), f"tick {tick}"
    assert [r.tokens for r in graphed.finished] == [r.tokens for r in eager.finished]
    for a, b in zip(tree_leaves(graphed.cache), tree_leaves(eager.cache)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert any(sp for _, sp in graphed.graphs.graphs) == (feature != "speculative")
    if feature != "sampled":
        assert graphed.stats()["spec_proposed"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("feature", ["sampled", "speculative", "both"])
def test_sampled_and_speculative_eager_steps_do_not_synchronise(feature):
    """The sampled and speculative steps on the staged inputs run under
    torch.cuda.set_sync_debug_mode("error") at both widths."""
    from repro_torch.launch.steps import run_step

    cuda_device()
    eng = _graph_engine("fp5.33", **(dict(speculate_k=2) if feature != "sampled" else {}))
    prompts, samp = _feature_requests(feature)
    for p, sp in zip(prompts, samp):
        eng.submit(p, 4, sampling=sp)
    eng.step()
    for width in (eng.step_chunk, 1):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.inputs.send()
            run_step(eng._step, eng.params, eng.cache, eng.inputs, eng.samp, width)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("feature", ["greedy", "sampled", "speculative"])
def test_split_step_equals_step_on_the_card(feature):
    """FP5.33 over AMS pages (K1, K2), reduced: one engine ticks through
    ``step()``, one through ``step_end(step_begin())``, whose first half
    replays the graph and returns before the device finishes; tokens every
    tick and every cache byte equal."""
    import numpy as np

    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.sampling import SamplingParams

    cuda_device()
    a, b = (_graph_engine("fp5.33", speculate_k=3 if feature == "speculative" else 0)
            for _ in range(2))
    rng = np.random.default_rng(9)
    for i in range(3):
        p = np.tile(rng.integers(1, 512, 4), 4).astype(np.int32)
        sp = SamplingParams(temperature=0.9, top_k=20, seed=i) if feature == "sampled" else None
        for eng in (a, b):
            eng.submit(p, 9, sampling=sp)
    while a.has_work or b.has_work:
        a.step()
        b.step_end(b.step_begin())
        assert [r and r.tokens for r in a.active] == [r and r.tokens for r in b.active]
    assert [r.tokens for r in a.finished] == [r.tokens for r in b.finished]
    assert all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(tree_leaves(a.cache), tree_leaves(b.cache)))


@pytest.mark.gpu
def test_frontend_streams_equal_the_direct_engine_on_the_card():
    """The HTTP front end over a card engine (its graphs captured on the
    stepping thread before it listens): a JSON and an SSE request return
    the tokens the same request gets from a direct engine."""
    import asyncio
    import json

    from repro_torch.launch.frontend import ServeFrontend

    cuda_device()
    prompt = list(range(1, 12))
    want = _graph_engine("fp5.33").submit(prompt, 6).result()
    eng = _graph_engine("fp5.33")
    fe = ServeFrontend(eng)

    async def go():
        await fe.start()
        assert len(eng.graphs.graphs) == 4          # (1, chunk) x (greedy, sampled)
        out = []
        for stream in (False, True):
            r, w = await asyncio.open_connection("127.0.0.1", fe.port)
            body = json.dumps({"prompt": prompt, "max_tokens": 6, "stream": stream}).encode()
            w.write(b"POST /v1/generate HTTP/1.1\r\nContent-Length: %d\r\n\r\n%s"
                    % (len(body), body))
            await w.drain()
            out.append((await r.read()).decode())
            w.close()
        await fe.stop()
        return out

    plain, sse = asyncio.run(go())
    assert json.loads(plain.partition("\r\n\r\n")[2])["tokens"] == want
    assert [json.loads(ln[6:])["token"] for ln in sse.splitlines()
            if ln.startswith("data: {\"token\"")] == want


def _mamba_engine(**kw):
    """Falcon-Mamba-7B at full width, cut to 2 layers, FP5.33 through K1, on
    the one-token step over its conv / ssm state caches."""
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine

    return ServeEngine(EngineConfig(arch="falcon-mamba-7b", reduced=False, depth=2,
                                    scheme="fp5.33-e2m3", impl="kernel", slots=3,
                                    capacity=64, device="cuda", seed=3, **kw))


@pytest.mark.gpu
def test_mamba_graph_replays_bit_equal_to_the_eager_step():
    """Two Mamba engines in lockstep, one replaying its graphs, one running
    the eager step: equal tokens every tick and equal state bytes. A seeded
    sampled request arrives mid-serve, so the sampled graph is captured
    (warm-up with every slot idle) while greedy requests hold live states;
    their streams and states still match the eager engine's. K1 is the only
    kernel launched."""
    from repro_torch.kernels import ams_matmul, attention_template
    from repro_torch.launch.sampling import SamplingParams
    from repro_torch.models.transformer import tree_leaves

    cuda_device()
    graphed, eager = _mamba_engine(), _mamba_engine()
    counts = (ams_matmul.COUNT, ams_matmul.COUNT_PLANES, attention_template.COUNT,
              attention_template.COUNT_BF16, attention_template.COUNT_CONTIG,
              attention_template.COUNT_MLA)
    for c in counts:
        c.reset()
    for e in (graphed, eager):
        for p in _graph_prompts()[:3]:
            e.submit(p, 8)
    tick = 0
    while graphed.has_work or eager.has_work:
        if tick == 5:
            late = SamplingParams(temperature=0.8, top_k=20, seed=4)
            for e in (graphed, eager):
                e.submit(_graph_prompts()[3], 6, sampling=late)
        graphed.step()
        eager.step(eager=True)
        tick += 1
        assert ([None if r is None else r.tokens for r in graphed.active]
                == [None if r is None else r.tokens for r in eager.active]), f"tick {tick}"
    assert [r.tokens for r in graphed.finished] == [r.tokens for r in eager.finished]
    for a, b in zip(tree_leaves(graphed.cache), tree_leaves(eager.cache)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert sorted(graphed.graphs.graphs) == [(1, False), (1, True)]
    assert counts[0].launches > 0 and all(c.launches == 0 for c in counts[1:])
    assert all(c.plain_on_cuda == 0 for c in counts)


@pytest.mark.gpu
def test_mamba_warm_up_keeps_live_states():
    """A capture's warm-up (a step with every slot idle) between live ticks
    leaves every state byte as it was."""
    from repro_torch.models.transformer import tree_leaves

    cuda_device()
    eng = _mamba_engine()
    for p in _graph_prompts()[:3]:
        eng.submit(p, 8)
    for _ in range(4):
        eng.step()
    before = [t.view(torch.uint8).clone() for t in tree_leaves(eng.cache)]
    eng.graphs.capture(1, sampled=False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, t.view(torch.uint8)) for a, t in zip(before, tree_leaves(eng.cache)))


@pytest.mark.gpu
def test_mamba_eager_step_does_not_synchronise():
    """The Mamba step (K1 projections, the masked in-place state update, the
    f32 multiply-adds) runs under set_sync_debug_mode("error")."""
    from repro_torch.launch.steps import run_step

    cuda_device()
    eng = _mamba_engine()
    for p in _graph_prompts()[:3]:
        eng.submit(p, 4)
    eng.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.inputs.send()
        run_step(eng._step, eng.params, eng.cache, eng.inputs, eng.samp, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_mamba_math_on_the_card_matches_the_cpu_path():
    """The Mamba mixer's CUDA branches against its CPU path on the same
    seeded f32 inputs: exp (device expf against XLA's CPU polynomial),
    log1p and softplus within 8 f32 ulp where the results are normal;
    `fma_f32` (one f32 addcmul against the exact f64 product) and the
    read-out at 8 rows (lanes of 8) within 2 f32 ulp of the sum of their
    terms' magnitudes, which bounds a product rounded before its add."""
    import numpy as np

    from repro_torch.models import ssm as S

    dev = cuda_device()
    rng = np.random.default_rng(11)
    ulp = 2.0 ** -23

    def both(fn, *xs):
        cpu = fn(*[torch.from_numpy(x) for x in xs])
        return fn(*[torch.from_numpy(x).to(dev) for x in xs]).cpu(), cpu

    for fn, lo, hi in ((S.exp_f32, -80.0, 80.0), (S.log1p_f32, -0.99, 50.0),
                       (S.softplus, -60.0, 60.0)):
        x = rng.uniform(lo, hi, 1 << 16).astype(np.float32)
        got, want = both(fn, x)
        torch.testing.assert_close(got, want, rtol=8 * ulp, atol=0)
    a, s_, b = (rng.standard_normal((8, 256, 16)).astype(np.float32) for _ in range(3))
    got, want = both(S.fma_f32, a, s_, b)
    bound = 2 * ulp * (np.abs(a * s_) + np.abs(b))
    assert bool((torch.abs(got - want) <= torch.from_numpy(bound)).all())
    h = rng.standard_normal((8, 256, 16)).astype(np.float32)
    c = rng.standard_normal((8, 1, 16)).astype(np.float32)
    d = rng.standard_normal(256).astype(np.float32)
    xc = rng.standard_normal((8, 256)).astype(np.float32)
    got, want = both(S.readout, h, c, d, xc)
    terms = (np.abs(h) * np.abs(c)).sum(-1) + np.abs(d * xc)
    assert bool((torch.abs(got - want) <= torch.from_numpy(2 * 16 * ulp * terms)).all())


@pytest.mark.gpu
def test_mamba_decode_on_the_card_matches_the_cpu_path():
    """`mamba_decode` on CUDA tensors (K1 projections, the device's exp /
    log1p, f32 multiply-adds) against the same layer on CPU tensors (K1's
    plain version, XLA's CPU math, the f64 fused multiply-add) on seeded
    inputs, reduced falcon-mamba-7b as the engine serves it at FP5.33: the
    conv state within one bf16 ulp of each element plus K1's 1e-4 of the
    largest (its tolerance against the plain version), the ssm state within
    1e-2 of max |h| and y within 2e-2 of max |y| (a bf16 activation that
    rounds the other way moves its row by a bf16 ulp of the largest)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.engine import prepare_params
    from repro_torch.models import init_params
    from repro_torch.models import ssm as S

    dev = cuda_device()
    cfg = get_config("falcon-mamba-7b").reduced()
    pol = QuantPolicy(scheme="fp5.33-e2m3", impl="kernel", min_elements=1 << 10)
    mixer = tree_map(lambda t: t[0], prepare_params(init_params(4, cfg), pol)
                     ["layers"]["sub0"]["mixer"])
    rng = np.random.default_rng(5)
    B = 8
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, cfg.ssm_conv - 1, cfg.d_inner)).astype(np.float32)
    ssm = rng.standard_normal((B, cfg.d_inner, cfg.ssm_state)).astype(np.float32)

    def run(device):
        t = [torch.from_numpy(v).to(device) for v in (x, conv, ssm)]
        p = tree_map(lambda v: v.to(device), mixer)
        y, (c, h) = S.mamba_decode(p, t[0].to(torch.bfloat16), t[1].to(torch.bfloat16), t[2],
                                   cfg, policy=pol)
        return y.float().cpu(), c.float().cpu(), h.cpu()

    (y, c, h), (wy, wc, wh) = run(dev), run("cpu")
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert bool((torch.abs(c - wc) <= 2.0 ** -7 * torch.abs(wc)
                 + 1e-4 * torch.abs(wc).max()).all())
    assert float(torch.abs(h - wh).max()) <= 1e-2 * float(torch.abs(wh).max())
    assert float(torch.abs(y - wy).max()) <= 2e-2 * float(torch.abs(wy).max())


def _hybrid_engine(**kw):
    """RecurrentGemma-9B at full width, cut to one (rec, rec, attn) repeat
    (3 layers), FP5.33 through K1, on the one-token step over its conv /
    recurrent states and 2048-slot rings."""
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine

    return ServeEngine(EngineConfig(arch="recurrentgemma-9b", reduced=False, depth=3,
                                    scheme="fp5.33-e2m3", impl="kernel", slots=3,
                                    capacity=64, device="cuda", seed=3, **kw))


@pytest.mark.gpu
def test_hybrid_graph_replays_bit_equal_to_the_eager_step():
    """Two RecurrentGemma engines in lockstep, one replaying its graphs,
    one running the eager step: equal tokens every tick and equal cache
    bytes (conv / recurrent states and ring entries). A seeded sampled
    request arrives mid-serve, so the sampled graph is captured (warm-up
    with every slot idle) while greedy requests hold live states; their
    streams and states still match the eager engine's. K1 is the only
    kernel launched: the ring attention never reaches K4."""
    from repro_torch.kernels import ams_matmul, attention_template
    from repro_torch.launch.sampling import SamplingParams
    from repro_torch.models.transformer import tree_leaves

    cuda_device()
    graphed, eager = _hybrid_engine(), _hybrid_engine()
    counts = (ams_matmul.COUNT, ams_matmul.COUNT_PLANES, attention_template.COUNT,
              attention_template.COUNT_BF16, attention_template.COUNT_CONTIG,
              attention_template.COUNT_MLA)
    for c in counts:
        c.reset()
    for e in (graphed, eager):
        for p in _graph_prompts()[:3]:
            e.submit(p, 8)
    tick = 0
    while graphed.has_work or eager.has_work:
        if tick == 5:
            late = SamplingParams(temperature=0.8, top_k=20, seed=4)
            for e in (graphed, eager):
                e.submit(_graph_prompts()[3], 6, sampling=late)
        graphed.step()
        eager.step(eager=True)
        tick += 1
        assert ([None if r is None else r.tokens for r in graphed.active]
                == [None if r is None else r.tokens for r in eager.active]), f"tick {tick}"
    assert [r.tokens for r in graphed.finished] == [r.tokens for r in eager.finished]
    for a, b in zip(tree_leaves(graphed.cache), tree_leaves(eager.cache)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert sorted(graphed.graphs.graphs) == [(1, False), (1, True)]
    assert counts[0].launches > 0 and all(c.launches == 0 for c in counts[1:])
    assert all(c.plain_on_cuda == 0 for c in counts)


@pytest.mark.gpu
def test_hybrid_warm_up_keeps_live_states_and_rings():
    """A capture's warm-up (a step with every slot idle) between live ticks
    leaves every state and ring byte as it was; so does a replay inside
    `recurrent_states_kept` for the states."""
    from repro_torch.launch.steps import recurrent_states_kept
    from repro_torch.models.transformer import tree_leaves

    cuda_device()
    eng = _hybrid_engine()
    for p in _graph_prompts()[:3]:
        eng.submit(p, 8)
    for _ in range(4):
        eng.step()
    before = [t.view(torch.uint8).clone() for t in tree_leaves(eng.cache)]
    eng.graphs.capture(1, sampled=False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, t.view(torch.uint8)) for a, t in zip(before, tree_leaves(eng.cache)))
    eng.step()
    before = [t.view(torch.uint8).clone() for t in tree_leaves(eng.cache)]
    with recurrent_states_kept(eng.cache, eng.cfg):
        eng.graphs(1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, t.view(torch.uint8)) for a, t in zip(before, tree_leaves(eng.cache)))


@pytest.mark.gpu
def test_rglru_math_on_the_card_matches_the_cpu_path():
    """The RG-LRU's CUDA math against its CPU path on the same seeded f32
    inputs: sigmoid (the device's against XLA's CPU expansion) and log
    (the Gumbel draw's) within 8 f32 ulp where the results are normal;
    sqrt within 1 ulp (both correctly rounded but for the device's
    flags)."""
    import numpy as np

    from repro_torch.core import xla_math as X

    dev = cuda_device()
    rng = np.random.default_rng(12)
    ulp = 2.0 ** -23
    for fn, lo, hi in ((X.sigmoid_f32, -80.0, 80.0), (X.log_f32, 1e-30, 1e30),
                       (X.sqrt_f32, 0.0, 1e6)):
        x = rng.uniform(lo, hi, 1 << 16).astype(np.float32)
        want = fn(torch.from_numpy(x))
        got = fn(torch.from_numpy(x).to(dev)).cpu()
        normal = want.abs() >= 2.0 ** -126
        torch.testing.assert_close(got[normal], want[normal],
                                   rtol=(ulp if fn is X.sqrt_f32 else 8 * ulp), atol=0)


@pytest.mark.gpu
def test_rglru_decode_on_the_card_matches_the_cpu_path():
    """`rglru_decode` on CUDA tensors (K1 projections, the device's exp /
    sigmoid / sqrt, an f32 multiply-add) against the same block on CPU
    tensors (K1's plain version, XLA's CPU math, the f64 fused multiply-
    add) on seeded inputs, reduced recurrentgemma-9b as the engine serves
    it at FP5.33, for a repeat's block (bf16 Λ) and the tail's (f32 Λ): the
    conv state within one bf16 ulp of each element plus K1's 1e-4 of the
    largest, the recurrent state within 1e-2 of max |h| and y within 2e-2
    of max |y| (a bf16 activation that rounds the other way moves its row
    by a bf16 ulp of the largest)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.engine import prepare_params
    from repro_torch.models import init_params
    from repro_torch.models import ssm as S

    dev = cuda_device()
    cfg = get_config("recurrentgemma-9b").reduced(num_layers=4)
    pol = QuantPolicy(scheme="fp5.33-e2m3", impl="kernel", min_elements=1 << 10)
    params = prepare_params(init_params(4, cfg), pol)
    rng = np.random.default_rng(5)
    B = 8
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, 3, cfg.lru_width)).astype(np.float32)
    state = rng.standard_normal((B, cfg.lru_width)).astype(np.float32)
    for mixer in (tree_map(lambda t: t[0], params["layers"]["sub0"]["mixer"]),
                  params["tail"]["sub0"]["mixer"]):
        def run(device):
            t = [torch.from_numpy(v).to(device) for v in (x, conv, state)]
            p = tree_map(lambda v: v.to(device), mixer)
            y, (c, h) = S.rglru_decode(p, t[0].to(torch.bfloat16), t[1].to(torch.bfloat16),
                                       t[2], cfg, policy=pol)
            return y.float().cpu(), c.float().cpu(), h.cpu()

        (y, c, h), (wy, wc, wh) = run(dev), run("cpu")
        assert torch.isfinite(y).all() and torch.isfinite(h).all()
        assert bool((torch.abs(c - wc) <= 2.0 ** -7 * torch.abs(wc)
                     + 1e-4 * torch.abs(wc).max()).all())
        assert float(torch.abs(h - wh).max()) <= 1e-2 * float(torch.abs(wh).max())
        assert float(torch.abs(y - wy).max()) <= 2e-2 * float(torch.abs(wy).max())


@pytest.mark.gpu
def test_failed_capture_raises():
    """No fallback: a step that cannot be captured makes the tick raise."""
    cuda_device()
    eng = _graph_engine("fp5.33")
    eng.submit(_graph_prompts()[0], 3)
    run = eng.graphs._run

    def syncing(width):
        out = run(width)
        int(out.sum())                      # a host sync: illegal while capturing
        return out

    eng.graphs._run = syncing
    with pytest.raises(RuntimeError):
        eng.step()
    assert eng.graphs.graphs == {}


# ------------------------------------------------------------ hygiene
def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], (ast.Constant, ast.JoinedStr))):
            arg = node.args[0]
            head = arg.value if isinstance(arg, ast.Constant) else ast.unparse(arg)
            yield head.strip("f'\"")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.launch.engine, "
            "repro_torch.kernels.ops, repro_torch.cache.paged_attention, "
            "repro_torch.models.convert, repro_torch.launch.train, repro_torch.optim, "
            "repro_torch.data, repro_torch.checkpoint, repro_torch.launch.fault_tolerance, "
            "repro_torch.launch.mesh, repro_torch.launch.sharding, "
            "repro_torch.models.parallel; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# ------------------------------------------------------------------- MoE
@pytest.mark.gpu
@pytest.mark.parametrize("K,N,B", [(5120, 8192, 8), (5120, 8192, 128), (8192, 5120, 8),
                                   (8192, 5120, 128), (5120, 1024, 8)])
def test_k1b_scout_expert_shapes_match_plain(K, N, B):
    """K1b at Llama-4-Scout-17B-16E's expert projections (gate / up 5120 ->
    8192, down 8192 -> 5120) and its wk / wv, at B = 8 and 128."""
    _k1b_case("fp4.25-e2m2", K, N, B, cuda_device())


def _moe_cfg(arch):
    from repro_torch.configs import get_config

    if arch == "dbrx-top4":     # DBRX's own top-4 over the reduced model's 4 experts
        return get_config("dbrx-132b").reduced(experts_per_token=4)
    return get_config(arch).reduced()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama4-scout-17b-16e", "dbrx-top4"])
def test_moe_block_on_the_card_matches_the_cpu_path(arch):
    """A reduced MoE model's FFN and one-token decode on the card (K1b for
    every expert, the shared expert and attention's projections; K2 over
    AMS pages) against its CPU path (the plain versions) from the same
    weights: the same experts routed for every row, `moe_dense` within
    2^-7 of its largest value (bf16 outputs of f32 sums in another order),
    two layers' logits within 5e-2 of the largest with equal argmax."""
    from repro_torch.cache import CacheConfig
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.engine import prepare_params
    from repro_torch.models import decode_step, init_params, make_cache
    from repro_torch.models import moe as M

    dev = cuda_device()
    cfg = _moe_cfg(arch)
    pol = QuantPolicy(scheme="fp4.25-e2m2", impl="kernel", min_elements=1 << 10)
    cpu = prepare_params(init_params(3, cfg), pol)
    gpu = tree_map(lambda t: t.to(dev), cpu)
    moe = tree_map(lambda t: t[0], cpu["layers"]["sub0"]["moe"])
    x = torch.randn((4, 3, cfg.d_model), generator=torch.Generator().manual_seed(1))
    x = x.to(torch.bfloat16)
    with M.record_routes() as r_cpu:
        y_cpu, _ = M.moe_dense(moe, x, cfg, pol)
    with M.record_routes() as r_gpu:
        y_gpu, _ = M.moe_dense(tree_map(lambda t: t.to(dev), moe), x.to(dev), cfg, pol)
    assert torch.equal(r_cpu[0][0].sort(-1).values, r_gpu[0][0].cpu().sort(-1).values)
    d = float((y_gpu.float().cpu() - y_cpu.float()).abs().max())
    assert d <= 2 ** -7 * float(y_cpu.float().abs().max())
    B = 3
    ccfg = CacheConfig(kind="paged_ams", page_size=8, impl="kernel").sized(capacity=32, slots=B)
    bt = torch.arange(B * ccfg.max_pages_per_seq, dtype=torch.int32).reshape(B, -1)
    tok = torch.tensor([5, 17, 301], dtype=torch.int32)
    pos = torch.tensor([0, 0, -1], dtype=torch.int32)
    logits = []
    for params, d_ in ((cpu, "cpu"), (gpu, dev)):
        cache = make_cache(cfg, cache_cfg=ccfg, device=d_)
        lg, _ = decode_step(params, tok.to(d_), cache, pos.to(d_), cfg, policy=pol,
                            block_tables=bt.to(d_), cache_cfg=ccfg)
        logits.append(lg[:2].float().cpu())
    assert float((logits[0] - logits[1]).abs().max()) <= 5e-2 * float(logits[0].abs().max())
    assert torch.equal(logits[0].argmax(-1), logits[1].argmax(-1))


@pytest.mark.gpu
def test_moe_graph_replays_bit_equal_to_the_eager_step():
    """Full-width Llama-4-Scout-17B-16E cut to 2 layers, FP4.25 over AMS
    pages (K1b: 55 launches a layer; K2): graph and eager engines in
    lockstep give equal tokens every tick and equal page bytes, the
    graphs of widths 1 and 4 used; K1b and K2 the only kernels launched."""
    from repro_torch.cache import CacheConfig
    from repro_torch.kernels import ams_matmul, attention_template
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.models.transformer import tree_leaves

    cuda_device()
    ec = EngineConfig(arch="llama4-scout-17b-16e", reduced=False, depth=2,
                      scheme="fp4.25-e2m2", impl="kernel", slots=3, capacity=64,
                      prefill_chunk=4, device="cuda", seed=3,
                      cache=CacheConfig(kind="paged_ams", page_size=16, impl="kernel"))
    graphed, eager = ServeEngine(ec), ServeEngine(ec)
    counts = (ams_matmul.COUNT, ams_matmul.COUNT_PLANES, attention_template.COUNT,
              attention_template.COUNT_BF16, attention_template.COUNT_CONTIG,
              attention_template.COUNT_MLA)
    for c in counts:
        c.reset()
    for p in _graph_prompts():
        graphed.submit(p, 5)
        eager.submit(p, 5)
    tick = 0
    while graphed.has_work or eager.has_work:
        graphed.step()
        eager.step(eager=True)
        tick += 1
        assert ([None if r is None else r.tokens for r in graphed.active]
                == [None if r is None else r.tokens for r in eager.active]), f"tick {tick}"
    assert [r.tokens for r in graphed.finished] == [r.tokens for r in eager.finished]
    for a, b in zip(tree_leaves(graphed.cache), tree_leaves(eager.cache)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert sorted(graphed.graphs.graphs) == [(1, False), (4, False)]
    assert {c.name for c in counts if c.launches} == {"ams_matmul_planes",
                                                      "paged_attention_ams"}
    assert all(c.plain_on_cuda == 0 for c in counts)


# -------------------------------------------------------------- training
# card against CPU, set from the worst case that the tests below print
# (measured on an H100 80GB HBM3, 700 W): one reduced train step's relative
# loss and grad-norm differences (1.21e-5, qwen2-7b; 5.86e-4, Scout), and
# twelve AdamW steps' params, m and v in ulp of each leaf's largest |value|
# (3.5, qwen2-7b's params) and the grad norm's relative difference (1.2e-7)
TRAIN_LOSS_REL, TRAIN_GNORM_REL = 1e-4, 3e-3
CARD_ADAMW_ULPS, CARD_ADAMW_GNORM_REL = 8, 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-7b", "llama4-scout-17b-16e", "falcon-mamba-7b"])
def test_train_step_on_the_card_matches_the_cpu_path(arch):
    """One `build_train_step` step of a reduced model (B 4 in 2
    microbatches of 32 tokens, remat on) on the card and on the CPU from the
    same params and batch: loss within TRAIN_LOSS_REL and grad norm within
    TRAIN_GNORM_REL of the CPU's (bf16 products summed in other orders),
    masters updated in place, the step counter advanced, the updated
    masters finite."""
    import dataclasses
    import json

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.tree import tree_items, tree_map
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import init_state

    dev = cuda_device()
    cfg = get_config(arch).reduced()
    rcfg = RunConfig(model=cfg, seq_len=32, global_batch=4, microbatch=2, warmup_steps=2,
                     learning_rate=1e-3)
    toks, tgts = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4)).batch(0)
    out = {}
    for device in ("cpu", dev):
        params = tree_map(lambda t: t.to(device), init_params(2, cfg))
        step = build_train_step(cfg, dataclasses.replace(rcfg), device)
        p, o, m = step(params, init_state(params), torch.from_numpy(toks).to(device),
                       torch.from_numpy(tgts).to(device), None, 0)
        assert p is params and int(o["step"]) == 1
        out[str(device)] = ({k: float(v) for k, v in m.items()}, p)
    (mc, pc), (mg, pg) = out["cpu"], out[str(dev)]
    loss_rel = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
    gnorm_rel = abs(mg["grad_norm"] - mc["grad_norm"]) / mc["grad_norm"]
    print("measured " + json.dumps(dict(arch=arch, loss_rel=loss_rel, grad_norm_rel=gnorm_rel)))
    assert loss_rel <= TRAIN_LOSS_REL
    assert gnorm_rel <= TRAIN_GNORM_REL
    assert mg["lr"] == mc["lr"]
    for _, t in tree_items(pg):
        assert torch.isfinite(t).all()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-7b", "minicpm3-4b"])
def test_apply_updates_on_the_card_matches_the_cpu_path(arch):
    """Twelve AdamW steps on a reduced model's f32 tree on the card and on
    the CPU from the same params and seeded grads (every other step clips:
    a global norm of about 0.5 sqrt(n), then about 0.5), with the learning
    rate and the step changing: params, m and v within CARD_ADAMW_ULPS ulp of
    each leaf's largest |value|, the grad norm within CARD_ADAMW_GNORM_REL,
    the step counters equal. Only ``w`` leaves decay, so a wrong decay, bias
    correction or clip shows in some leaf."""
    import json

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_items, tree_map
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, apply_updates, init_state

    dev = cuda_device()
    cpu = init_params(0, get_config(arch).reduced())
    card = tree_map(lambda t: t.to(dev, copy=True), cpu)
    s_cpu, s_card = init_state(cpu), init_state(card)
    n = sum(t.numel() for _, t in tree_items(cpu))
    gen = torch.Generator().manual_seed(0)
    worst = dict(arch=arch, p=0.0, m=0.0, v=0.0, grad_norm_rel=0.0)
    for it in range(12):
        scale = 0.5 / math.sqrt(n) if it % 2 else 0.5
        g = tree_map(lambda t: scale * torch.randn(t.shape, generator=gen), cpu)
        lr = 1e-3 * (it + 1)
        card, s_card, m_card = apply_updates(card, tree_map(lambda t: t.to(dev), g), s_card,
                                             lr, AdamWConfig())
        cpu, s_cpu, m_cpu = apply_updates(cpu, g, s_cpu, lr, AdamWConfig())
        gn = float(m_cpu["grad_norm"])
        assert (gn > 1.0) == (it % 2 == 0)
        worst["grad_norm_rel"] = max(worst["grad_norm_rel"],
                                     abs(float(m_card["grad_norm"]) - gn) / gn)
        for key, want, got in (("p", cpu, card), ("m", s_cpu["m"], s_card["m"]),
                               ("v", s_cpu["v"], s_card["v"])):
            for (path, a), (_, b) in zip(tree_items(want), tree_items(got)):
                a = a.numpy()
                ulps = float(np.abs(b.cpu().numpy() - a).max() / np.spacing(np.abs(a).max()))
                worst[key] = max(worst[key], ulps)
        assert int(s_card["step"]) == int(s_cpu["step"]) == it + 1
    print("measured " + json.dumps(worst))
    assert max(worst["p"], worst["m"], worst["v"]) <= CARD_ADAMW_ULPS, worst
    assert worst["grad_norm_rel"] <= CARD_ADAMW_GNORM_REL, worst


# ------------------------------------------------------ tensor-parallel shards
@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["fp5.33-e2m3", "fp4.25-e2m2"])
@pytest.mark.parametrize("K,N", [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
                                 (5120, 8192), (8192, 5120), (5120, 1024)])
def test_k1_n_shard_columns_equal_the_whole_launch(scheme, K, N):
    """K1 (fp5.33) and K1b (fp4.25) on a rank's N / tp columns of Qwen2-7B's
    and Llama-4-Scout's projections (the serving layout's shards, planned
    with the whole linear's K split) give the whole launch's columns bit for
    bit, at tp 2 and 4 and B 8 and 128."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.launch.sharding import shard_tree
    from repro_torch.models.common import apply_linear, quantize_params

    dev = cuda_device()
    pol = QuantPolicy(scheme=scheme, impl="kernel", min_elements=1)
    gen = torch.Generator(device=dev).manual_seed(K + N)
    w = (torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)).to(torch.bfloat16)
    p = quantize_params({"wq": {"w": w}}, pol)["wq"]
    for B in (8, 128):
        x = torch.randn((B, K), generator=gen, device=dev).to(torch.bfloat16).float()
        whole = apply_linear(p, x, pol)
        for tp in (2, 4):
            n = N // tp
            for r in range(tp):
                shard = shard_tree({"wq": p}, r, tp, ["layers", "sub0", "attn"], n_stack=0)["wq"]
                got = apply_linear(shard, x, pol, shards=tp)
                assert torch.equal(got, whole[:, r * n:(r + 1) * n]), (B, tp, r)

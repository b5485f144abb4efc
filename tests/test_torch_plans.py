"""The Hopper launch plans of K1, K1b, K2, K3, K4, K5 and K5p
(`repro_torch.kernels.tuning`), and torch emulations of what the CUDA
kernels rely on, on the CPU.

`plan_ams_matmul` tiles K1's and K1b's output and splits K over a
thread-block cluster; `plan_contiguous_attention` / `plan_mla_attention` and
`attention_shares` split K4's / K5's key blocks over a cluster;
`plan_paged_attention` splits K2's visible tokens,
`plan_paged_bf16_attention` / `plan_paged_mla_attention` and
`paged_segments` K3's / K5p's. These tests hold the plans to what the
kernels rely on (every word row, key and token in exactly
one split, every lsb row read by the ranks whose word rows need it,
k-group aligned K splits, clusters of at most 8, enough CTAs to fill the
card at the served shapes, scores that fit in shared memory and K5 shares
that stay resident at every served shape), and check the arguments with
torch emulations (here, not in the package): K4's and K5's split walks
against `contiguous_attention_plain` / `contiguous_attention_mla_plain`
within their element rule (K5's bf16(p) bit for bit the one-rank walk's;
forming p at a rank-local max is caught); K2's token split (each row's
own shares, each rank's own running max, the rank-order (m, l, acc)
merge) against `_paged_online_softmax` (an unweighted merge is caught),
and a row's bits the same at every tile height; the page-max
contract on pages walked in sub-tiles of 32 tokens (the page's max formed
over every sub-tile before any p); K3's and K5p's token splits against
`_paged_online_softmax` (bf16 pages: the one-exchange prefix max, bf16(p)
bit for bit the plain walk's, a rank-local max caught; AMS pages: each
rank's own max and the rank-order merge, an unweighted merge caught); and
K1b's `PlanesDecode<HB, KS, M>` hook for every hi width (the lift and bit
operations that turn planes into bf16x2 values, the lsb bits each word
takes, the order x's fragments follow) against `code_to_value`, bit for
bit, the ring's shared memory against the planner's, and a bank model of
the fragment loads.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.formats import code_to_value, get_scheme  # noqa: E402
from repro_torch.core.packing import make_layout  # noqa: E402
from repro_torch.kernels.ams_matmul import planes_on_tensor_cores, unpack_planes  # noqa: E402
from repro_torch.kernels.attention_template import (  # noqa: E402
    NEG_BIG,
    NEG_CLAMP,
    _paged_online_softmax,
    contiguous_attention_mla_plain,
    contiguous_attention_plain,
)
from repro_torch.kernels.tuning import (  # noqa: E402
    ATT_ROWS,
    K1_GROUP_WORDS,
    K3_SCORE_KEYS_MAX,
    MAX_CLUSTER,
    MLA_RESIDENT_KEYS,
    MLA_ROWS,
    PAGED_ROW_TILES,
    PAGED_SUB_KEYS,
    SMS,
    attention_shares,
    k1_lsb_rows,
    k1_stage_rows,
    paged_row_shares,
    paged_segments,
    plan_ams_matmul,
    plan_contiguous_attention,
    plan_mla_attention,
    plan_paged_attention,
    plan_paged_bf16_attention,
    plan_paged_mla_attention,
    reference_block_kv,
)


def _projections(arch):
    """(name, K, N) of every projection K1 serves for ``arch`` at full width
    (a MoE model's experts and shared expert have the FFN's shapes)."""
    cfg = get_config(arch)
    D = cfg.d_model
    if arch in ("qwen2-7b", "llama4-scout-17b-16e"):
        hd = cfg.head_dim
        return [("wq", D, cfg.num_heads * hd), ("wo", cfg.num_heads * hd, D),
                ("wk", D, cfg.num_kv_heads * hd), ("wv", D, cfg.num_kv_heads * hd),
                ("w_gate", D, cfg.d_ff), ("w_up", D, cfg.d_ff), ("w_down", cfg.d_ff, D)]
    H, dn, dr = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    return [("wq_a", D, cfg.q_lora_rank), ("wq_b", cfg.q_lora_rank, H * (dn + dr)),
            ("wkv_a", D, cfg.kv_lora_rank + dr), ("wo", H * cfg.v_head_dim, D),
            ("w_gate", D, cfg.d_ff), ("w_up", D, cfg.d_ff), ("w_down", cfg.d_ff, D)]


PROJECTIONS = [(arch, *p) for arch in ("qwen2-7b", "minicpm3-4b", "llama4-scout-17b-16e")
               for p in _projections(arch)]


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("B,K,N", [(1, 6, 1), (5, 700, 300), (8, 3584, 512), (33, 2048, 640),
                                   (128, 18944, 3584), (200, 700, 520), (8, 97 * 6, 40),
                                   (2, 6 * 8 * 9 + 6, 288)])
def test_k1_plan_covers_every_word_row_once(B, K, N):
    Kw = math.ceil(K / 6)
    plan = plan_ams_matmul(B, Kw, N)
    covered = np.zeros(Kw, dtype=int)
    for lo, hi in plan.splits(Kw):
        assert lo < hi, "a rank without word rows"
        assert lo % K1_GROUP_WORDS == 0           # on a 48-K boundary
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert 1 <= plan.cluster <= MAX_CLUSTER
    assert plan.split_words % K1_GROUP_WORDS == 0
    assert plan.tn * plan.col_tiles >= N and plan.tn * (plan.col_tiles - 1) < N
    assert 8 * plan.nt * plan.row_tiles >= B and plan.nt in (1, 2, 4, 8, 16)


@pytest.mark.parametrize("arch,name,K,N", PROJECTIONS,
                         ids=[f"{a}-{n}" for a, n, _, _ in PROJECTIONS])
def test_k1_plan_fills_the_card_at_decode(arch, name, K, N):
    """At B = 8 (8 decoding slots): at least one CTA per SM for Qwen2-7B's
    wq/wo, w_gate/w_up and w_down, at least 64 for wk/wv and every
    MiniCPM3-4B projection."""
    plan = plan_ams_matmul(8, math.ceil(K / 6), N)
    want = SMS if arch == "qwen2-7b" and name not in ("wk", "wv") else 64
    assert plan.ctas >= want, plan


# ------------------------------------------------------------------ K1b
PLANES_4BIT = ("fp4.5-e2m2", "fp4.33-e2m2", "fp4.25-e2m2", "fp4-e2m1")


def test_tensor_core_planes_are_the_4bit_schemes():
    """Every planes layout of a registered scheme goes through the
    tensor-core kernel, fp5.33-e2m3 packed as planes too (per_word 6);
    3-bit fields (e2m1 with a shared LSB, per_word 10) and k > 4 do not."""
    from repro_torch.core.formats import SCHEMES, AMSFormat, get_format

    on = {n for n, sc in SCHEMES.items()
          if make_layout(sc).container == "planes" and planes_on_tensor_cores(make_layout(sc))}
    assert on == {n for n, sc in SCHEMES.items() if make_layout(sc).container == "planes"}
    assert set(PLANES_4BIT) < on and {"fp8", "fp6-e2m3", "fp6-e3m2", "fp5-e2m2"} < on
    assert planes_on_tensor_cores(make_layout(get_scheme("fp5.33-e2m3"), "planes"))
    assert not planes_on_tensor_cores(make_layout(AMSFormat(get_format("e2m1"), 2)))
    assert not planes_on_tensor_cores(make_layout(AMSFormat(get_format("e2m2"), 5)))


def _lsb_rows_read(lo: int, hi: int, k: int):
    """The lsb rows K1b's rank reads for word rows [lo, hi): those of the
    groups of K positions [8 lo, 8 hi)."""
    return range((8 * lo // k) >> 5, ((8 * hi - 1) // k >> 5) + 1)


@pytest.mark.parametrize("scheme", ["fp4.5-e2m2", "fp4.33-e2m2", "fp4.25-e2m2"])
@pytest.mark.parametrize("B,K,N", [(1, 128, 1), (5, 700, 300), (8, 3584, 512), (33, 2048, 640),
                                   (128, 18944, 3584), (8, 3584, 18944), (200, 700, 520)])
def test_k1b_plan_covers_every_hi_and_lsb_row_once(scheme, B, K, N):
    """Every word row in exactly one rank, on 64-K boundaries; every lsb row
    read by a rank that needs it, by two only where a split falls inside
    it (its 32 k positions then belong to both ranks' word rows)."""
    lay = make_layout(get_scheme(scheme))
    k = lay.scheme.k
    Kp = lay.padded_k(K)
    Kw, Lrows = Kp // 8, Kp // (32 * k)
    plan = plan_ams_matmul(B, Kw, N, container="planes", k=k)
    hi_seen, lsb_seen = np.zeros(Kw, dtype=int), np.zeros(Lrows, dtype=int)
    for lo, hi in plan.splits(Kw):
        assert lo < hi and lo % K1_GROUP_WORDS == 0
        hi_seen[lo:hi] += 1
        for r in _lsb_rows_read(lo, hi, k):
            lsb_seen[r] += 1
    assert (hi_seen == 1).all()
    assert (lsb_seen >= 1).all()
    cut = {(8 * lo) // (32 * k) for lo, _ in plan.splits(Kw)[1:] if (8 * lo) % (32 * k)}
    assert set(np.nonzero(lsb_seen == 2)[0]) <= cut and lsb_seen.max() <= 2
    assert 1 <= plan.cluster <= MAX_CLUSTER and plan.ctas >= 1


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("nt", [1, 2, 4, 8, 16])
def test_k1b_stage_holds_the_lsb_rows_its_word_rows_read(nt, k):
    """A ring stage of RW word rows starting on any k-group boundary reads
    at most `k1_lsb_rows` lsb rows (the rows the kernel copies per stage)."""
    rw = k1_stage_rows(nt)
    most = max(len(_lsb_rows_read(w0, w0 + rw, k)) for w0 in range(0, 96 * k, K1_GROUP_WORDS))
    assert most <= k1_lsb_rows(rw, k)


QWEN = [p for p in PROJECTIONS if p[0] == "qwen2-7b"]


@pytest.mark.parametrize("arch,name,K,N", QWEN, ids=[n for _, n, _, _ in QWEN])
def test_k1b_plan_fills_the_card_at_decode(arch, name, K, N):
    """fp4.25 at Qwen2-7B's projections, B = 8 (8 decoding slots): at least
    one CTA per SM, at least 64 for wk/wv."""
    plan = plan_ams_matmul(8, K // 8, N, container="planes", k=4)
    assert plan.ctas >= (64 if name in ("wk", "wv") else SMS), plan


def _u32(t):
    return t & 0xFFFFFFFF


def _bf16_bits_to_f32(bits):
    """16-bit bf16 patterns (int64) -> f32 values, exactly."""
    v = _u32(bits << 16)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32).view(torch.float32)


def _hook(hb: int):
    """PlanesDecode<HB, KS>'s constants: (PW, kLift, kShift, kPairs)."""
    pw = 32 // hb
    lift = {8: 4, 4: 2}.get(pw, 3)
    return pw, lift, 16 - hb * lift, pw - lift


def _shift(v, s: int):
    """PlanesDecode::shift: v shifted right by s (left by -s when s < 0)."""
    return v >> s if s >= 0 else _u32(v << -s)


def _planes_lsb_bits(lsb, kw, k: int, pw: int = 8):
    """PlanesDecode::lsb_bits for every column of word rows kw (a tensor):
    the lsb bits from group G0 = pw kw / k on, and the word's phase in its
    group; the kernel's compile-time claims (no phase where k divides pw, no
    second lsb row where a word's groups align with 32) hold."""
    G0 = pw * kw // k
    ph = pw * kw - k * G0
    off = G0 & 31
    bits = lsb[G0 >> 5] >> off[:, None]
    cross = ((pw * kw + pw - 1) // k) >> 5 != G0 >> 5
    if pw % k == 0:
        assert (ph == 0).all()
        if 32 % (pw // k) == 0:
            assert not cross.any()
    nxt = lsb[torch.clamp((G0 >> 5) + 1, max=lsb.shape[0] - 1)]
    up = (32 - off).clamp(max=31)[:, None]            # off = 0 never crosses
    bits = torch.where(cross[:, None], _u32(bits | (nxt << up)), bits)
    return bits, ph


def _planes_block_pairs(w0, w1, b0, b1, ph0, ph1, hb: int, k: int, fmt):
    """PlanesDecode<HB, KS, M>::block_pairs for words w0 (row 2t of a block)
    and w1 (row 2t + 1), every column: the lift, two shifts and two masks per
    pair, the LSBs (k > 1) and the multiply by 2^(127 - bias) (in f32:
    exact, as the bf16x2 multiply is). Returns [(lo, hi, pa, pb)] in x's
    order: the values and their K positions within the block (w0: 0..pw-1,
    w1: pw..2pw-1)."""
    pw, lift, shift, pairs = _hook(hb)
    dst = 7 - fmt.man_bits
    dm = dst + (1 if k > 1 else 0)
    mag2 = (((1 << (hb - 1)) - 1) * 0x00010001) << dm

    def lifted(w):
        if shift == 0:
            return w
        moved = (w << shift) if shift > 0 else (w >> -shift)
        return (w & 0xFFFF) | (moved & 0xFFFF0000)

    def pair_bits(v, p):
        return (_shift(v, p - dm) & mag2) | (_shift(v, p + hb - 16) & 0x80008000)

    def lsb_pair(ba, pha, ja, bb, phb, jb):
        lo = (ba >> ((pha + ja) // k)[:, None]) & 1
        hi = (bb >> ((phb + jb) // k)[:, None]) & 1
        return (lo | (hi << 16)) << dst

    v0, v1 = lifted(w0), lifted(w1)
    out = []
    for word, v, bb, ph, base in ((w0, v0, b0, ph0, 0), (w1, v1, b1, ph1, pw)):
        for j in range(pairs):
            r = pair_bits(v, hb * j)
            if k > 1:
                r = r | lsb_pair(bb, ph, j, bb, ph, j + lift)
            out.append((r, base + j, base + j + lift))
    for j in range(pairs, lift):                      # HB 6: field 2 of w0 and w1
        c = ((w0 >> (hb * j)) & 0xFFFF) | ((w1 << (16 - hb * j)) & 0xFFFF0000)
        r = pair_bits(c, 0)
        if k > 1:
            r = r | lsb_pair(b0, ph0, j, b1, ph1, j)
        out.append((r, j, pw + j))
    mul = torch.tensor(2.0 ** (127 - fmt.bias), dtype=torch.float32)
    return [(_bf16_bits_to_f32(r & 0xFFFF) * mul, _bf16_bits_to_f32(r >> 16) * mul, pa, pb)
            for r, pa, pb in out]


def _check_planes_decode(sc, lay):
    """Every hi field value at every field position of a word (columns c:
    value (kw + j + c) mod 2^hb), with either LSB (columns n + c: the lsb
    words flipped), at every phase of a word in its k-group and across lsb
    rows: PlanesDecode's pairs equal `code_to_value` of the unpacked codes,
    bit for bit, and cover every K position once."""
    hb, pw, k = lay.hi_bits, lay.per_word, sc.k
    n = max(16, 1 << hb)
    kw0 = 32 * k // math.gcd(pw, 32 * k)             # word rows per whole lsb row
    Kw = kw0 * -(-48 // kw0)
    Kw += Kw % 2
    field = (torch.arange(Kw)[:, None, None] + torch.arange(pw)[None, :, None]
             + torch.arange(n)[None, None, :]) % (1 << hb)                 # [Kw, pw, n]
    words = (field << (hb * torch.arange(pw))[None, :, None]).sum(dim=1)   # [Kw, n]
    words = torch.cat([words, words], dim=1)
    if k > 1:
        gen = torch.Generator().manual_seed(k + 10 * hb)
        lsb = torch.randint(0, 2 ** 32, (Kw * pw // (32 * k), n), generator=gen,
                            dtype=torch.int64)
        lsb = torch.cat([lsb, _u32(~lsb)], dim=1)
    else:
        lsb = torch.zeros((0, 2 * n), dtype=torch.int64)
    wrap = lambda t: torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32)  # noqa: E731
    want = code_to_value(sc.base, unpack_planes(wrap(words), wrap(lsb), lay))  # [pw Kw, 2n]
    kw = torch.arange(0, Kw, 2)                                  # rows 2t of the blocks
    if k > 1:
        b0, ph0 = _planes_lsb_bits(lsb, kw, k, pw)
        b1, ph1 = _planes_lsb_bits(lsb, kw + 1, k, pw)
    else:
        b0 = b1 = None
        ph0 = ph1 = torch.zeros_like(kw)
    seen = torch.zeros(pw * Kw, dtype=torch.int64)
    for lo, hi, pa, pb in _planes_block_pairs(words[0::2], words[1::2], b0, b1, ph0, ph1, hb,
                                              k, sc.base):
        for got, p in ((lo, pa), (hi, pb)):
            pos = pw * kw + p
            assert torch.equal(got.view(torch.int32), want[pos].view(torch.int32)), \
                (sc.name, p)
            seen[pos] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("scheme", PLANES_4BIT)
def test_k1b_planes_decode_is_code_to_value_bit_for_bit(scheme):
    """The 4-bit planes (PlanesDecode<4, KS>: fields j and j + 4 16 bits
    apart, no lift), every field value, LSB and phase, bit for bit."""
    sc = get_scheme(scheme)
    _check_planes_decode(sc, make_layout(sc))


def _wide_planes():
    """(name, scheme, layout) of every base format and k <= 4 whose planes
    have per_word 4, 5 or 6."""
    from repro_torch.core.formats import FORMATS, AMSFormat

    out = []
    for fname, fmt in FORMATS.items():
        for k in range(1, 5):
            sc = AMSFormat(fmt, k)
            lay = make_layout(sc, "planes")
            if lay.per_word in (4, 5, 6):
                out.append((f"{fname}-k{k}", sc, lay))
    return out


WIDE_PLANES = _wide_planes()


def test_wide_planes_cover_the_named_layouts():
    names = {n for n, _, _ in WIDE_PLANES}
    assert {"e4m3-k1", "e2m3-k1", "e3m2-k1", "e2m2-k1", "e2m3-k3", "e4m3-k2",
            "e3m3-k3", "e5m2-k1"} <= names
    assert {lay.per_word for _, _, lay in WIDE_PLANES} == {4, 5, 6}
    assert {lay.hi_bits for _, _, lay in WIDE_PLANES} == {5, 6, 7, 8}


@pytest.mark.parametrize("name,sc,lay", WIDE_PLANES, ids=[n for n, _, _ in WIDE_PLANES])
def test_k1b_wide_planes_decode_is_code_to_value_bit_for_bit(name, sc, lay):
    """PlanesDecode<HB, KS> for per_word 4 (HB 7, 8), 5 (HB 6: fields 3, 4
    lifted under 0, 1, field 2 paired across the block's words) and 6 (HB
    5: fp533's lift): every field value, LSB and phase, bit for bit."""
    _check_planes_decode(sc, lay)


def _byte_perm(a: int, b: int, sel: int) -> int:
    """CUDA's __byte_perm(a, b, sel) (selector nibbles 0-7)."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def test_k1b_x_fragments_follow_the_pair_order():
    """For every k-step s and quad index t, the K positions of x's B
    fragments (PlanesDecode::x_fragments: two 16-byte loads and byte
    permutes) are those of the weight pairs in the A fragments (a[s][0]:
    pair 2s, a[s][2]: pair 2s + 1 of the thread's 8 pairs, words W0 = rows
    2t, W1 = 2t + 1): each mma.sync sums x[p] * w[p] over matching p."""
    for t in range(4):
        base = 16 * t                                        # the thread's 16 K positions
        pairs = [(base + j, base + j + 4) for j in range(4)] + \
                [(base + 8 + j, base + 12 + j) for j in range(4)]
        xr = [base + i for i in range(16)]                  # bf16 holding its own position
        q = [xr[2 * i] | (xr[2 * i + 1] << 16) for i in range(8)]   # the 32-bit words loaded
        q0x, q0y, q0z, q0w, q1x, q1y, q1z, q1w = q
        b = [[_byte_perm(q0x, q0z, 0x5410), _byte_perm(q0x, q0z, 0x7632)],
             [_byte_perm(q0y, q0w, 0x5410), _byte_perm(q0y, q0w, 0x7632)],
             [_byte_perm(q1x, q1z, 0x5410), _byte_perm(q1x, q1z, 0x7632)],
             [_byte_perm(q1y, q1w, 0x5410), _byte_perm(q1y, q1w, 0x7632)]]
        for s in range(4):
            for e in range(2):
                assert (b[s][e] & 0xFFFF, b[s][e] >> 16) == pairs[2 * s + e], (t, s, e)
        covered = sorted(p for pr in pairs for p in pr)
        assert covered == xr


def _x_pairs(pw: int, q):
    """x_pairs<PW>: the byte permutes of the thread's 32-bit words q (x's
    2 PW bf16 of one block, two per word, low half first)."""
    bp = _byte_perm
    if pw == 8:
        return [bp(q[0], q[2], 0x5410), bp(q[0], q[2], 0x7632), bp(q[1], q[3], 0x5410),
                bp(q[1], q[3], 0x7632), bp(q[4], q[6], 0x5410), bp(q[4], q[6], 0x7632),
                bp(q[5], q[7], 0x5410), bp(q[5], q[7], 0x7632)]
    if pw == 6:
        return [bp(q[0], q[1], 0x7610), bp(q[0], q[2], 0x5432), bp(q[1], q[2], 0x7610),
                bp(q[3], q[4], 0x7610), bp(q[3], q[5], 0x5432), bp(q[4], q[5], 0x7610)]
    if pw == 5:
        return [bp(q[0], q[1], 0x7610), bp(q[0], q[2], 0x5432), bp(q[2], q[4], 0x5432),
                bp(q[3], q[4], 0x7610), bp(q[1], q[3], 0x7610)]
    return [bp(q[0], q[1], 0x5410), bp(q[0], q[1], 0x7632), bp(q[2], q[3], 0x5410),
            bp(q[2], q[3], 0x7632)]


@pytest.mark.parametrize("hb", [5, 6, 7, 8])
def test_k1b_wide_x_fragments_follow_the_pair_order(hb):
    """For per_word 6, 5 and 4: the K positions of x's B fragments (x_pairs
    over each block of the thread's words, k-step s taking pairs 2s and
    2s + 1 of the group) are those of PlanesDecode's pairs in the A
    fragments, and each of the thread's K positions appears once."""
    pw, lift, _, pairs = _hook(hb)
    blocks = 2 if pw == 5 else 1
    for t in range(4):
        hook, xs = [], []
        for blk in range(blocks):
            base = 8 * pw * blk + 2 * pw * t                   # the block's x offset
            hook += [(base + j, base + j + lift) for j in range(pairs)]
            hook += [(base + pw + j, base + pw + j + lift) for j in range(pairs)]
            hook += [(base + j, base + pw + j) for j in range(pairs, lift)]
            xr = [base + i for i in range(2 * pw)]
            q = [xr[2 * i] | (xr[2 * i + 1] << 16) for i in range(pw)]
            xs += [(v & 0xFFFF, v >> 16) for v in _x_pairs(pw, q)]
        assert xs == hook, (hb, t)
        assert len(hook) % 2 == 0 and len(hook) // 2 == blocks * pw // 2     # kSteps
        assert sorted(p for pr in hook for p in pr) == sorted(
            8 * pw * blk + 2 * pw * t + i for blk in range(blocks) for i in range(2 * pw))


def _phases(addrs, width: int):
    """Shared-memory wavefronts of one warp-wide load of ``width`` bytes per
    lane at byte addresses ``addrs``: the warp splits into phases of 128
    bytes (32 lanes at 4 bytes, 16 at 8, 8 at 16); a phase costs as many
    wavefronts as lanes that hit one bank at distinct addresses."""
    lanes = 128 // width
    total = 0
    for ph in range(0, 32, lanes):
        banks = {}
        for a in addrs[ph:ph + lanes]:
            for w in range(a // 4, (a + width) // 4):
                banks.setdefault(w % 32, set()).add(w)
        total += max(len(v) for v in banks.values())
    return total


def _x_loads(pw: int, xs: int):
    """The byte addresses of each x_pairs<PW> load of a warp (lane g, t
    reads row g of x, the block's 2 PW bf16 at 2 PW t) and its width."""
    width, n = {8: (16, 2), 6: (8, 3), 5: (4, 5), 4: (16, 1)}[pw]
    return [([2 * (g * xs + 2 * pw * t) + width * i for g in range(8) for t in range(4)], width)
            for i in range(n)]


def _k1_shape(pw: int, k: int, tn: int, nt: int, fp533: bool = False):
    """K1Shape<WN, NT, Dec> of csrc/ams_matmul.cu, restated from its
    constants: (RW, LR, XS, ring bytes)."""
    gw = 16 if pw == 5 else 8
    rw = max(8 if nt >= 16 else (16 if nt >= 4 else 32), gw)
    share = 0 if fp533 or k == 1 else k
    lsb_k = 32 * (share or 1)
    lr = (rw * pw + lsb_k - 1) // lsb_k + 1 if share else 0
    xmod, period = (16, 64) if fp533 else {4: (32, 64), 5: (8, 16), 6: (16, 64), 8: (8, 64)}[pw]
    xk = rw * pw
    xs = xk + ((xmod - xk) % period + period) % period
    stage = (rw + lr) * (tn + 4) * 4 + 8 * nt * xs * 2
    return rw, lr, xs, max(4 * stage, tn * 8 * nt * 4)


TILES = [(32, 1), (32, 2), (32, 4), (32, 8), (64, 1), (64, 2), (64, 4), (64, 8), (128, 16)]


@pytest.mark.parametrize("pw", [4, 5, 6, 8])
def test_k1b_ring_bytes_match_k1shape_and_loads_are_conflict_free(pw):
    """`k1_ring_bytes` (what the planner fits on an SM) equals K1Shape's
    ring at every tile and k; a stage holds whole k-groups; x's fragment
    loads (x_pairs at the hook's row stride) and the weight fragments'
    8-byte loads (rows 2t, 2t + 1 of a block, columns 2g, stride TN + 4)
    take the fewest wavefronts the widths allow."""
    from repro_torch.kernels.tuning import k1_group_words, k1_ring_bytes

    for tn, nt in TILES:
        for k in (1, 2, 3, 4):
            rw, lr, xs, ring = _k1_shape(pw, k, tn, nt)
            assert k1_ring_bytes(tn, nt, "planes", k, pw) == ring, (tn, nt, k)
            assert k1_stage_rows(nt, pw) == rw and rw % k1_group_words(pw) == 0
            if k > 1:
                assert k1_lsb_rows(rw, k, pw) == lr
            for addrs, width in _x_loads(pw, xs):
                assert _phases(addrs, width) == 32 * width // 128, (tn, nt, xs, width)
        ws = tn + 4
        for r in range(2):                                      # rows 2t and 2t + 1
            addrs = [4 * ((2 * t + r) * ws + 2 * g) for g in range(8) for t in range(4)]
            assert _phases(addrs, 8) == 2
    for tn, nt in TILES:                                        # K1 (fp533) unchanged
        assert k1_ring_bytes(tn, nt) == _k1_shape(6, 1, tn, nt, fp533=True)[3]


WIDE_SCHEMES = ["fp8", "fp6-e2m3", "fp6-e3m2", "fp5-e2m2"]


@pytest.mark.parametrize("name,k,pw", [("fp8", 1, 4), ("fp6-e2m3", 1, 5), ("fp6-e3m2", 1, 5),
                                       ("fp5-e2m2", 1, 6), ("fp5.33-planes", 3, 6),
                                       ("e4m3-k2", 2, 4), ("e3m3-k3", 3, 5), ("e3m3-k4", 4, 5),
                                       ("e3m2-k4", 4, 6)])
@pytest.mark.parametrize("B,K,N", [(1, 5, 1), (5, 700, 300), (8, 3584, 512), (33, 2048, 640),
                                   (128, 18944, 3584), (8, 3584, 18944), (200, 700, 520)])
def test_k1b_wide_plan_covers_every_hi_and_lsb_row_once(name, k, pw, B, K, N):
    """per_word 4, 5 and 6: every word row in exactly one rank, splits on
    k-group boundaries (16 word rows at per_word 5, 8 otherwise); every lsb
    row read by a rank that needs it; a ring stage starting on any k-group
    boundary reads at most the lsb rows it copies."""
    from repro_torch.kernels.tuning import k1_group_words

    k_block = pw if k == 1 else math.lcm(pw, 32 * k)
    Kp = -(-K // k_block) * k_block
    Kw = Kp // pw
    gw = k1_group_words(pw)
    plan = plan_ams_matmul(B, Kw, N, container="planes", k=k, per_word=pw)
    assert plan.split_words % gw == 0 and 1 <= plan.cluster <= MAX_CLUSTER
    hi_seen = np.zeros(Kw, dtype=int)
    lsb_seen = np.zeros(max(Kp // (32 * k), 1), dtype=int)
    for lo, hi in plan.splits(Kw):
        assert lo < hi and lo % gw == 0
        hi_seen[lo:hi] += 1
        if k > 1:
            for r in range((pw * lo // k) >> 5, ((pw * hi - 1) // k >> 5) + 1):
                lsb_seen[r] += 1
    assert (hi_seen == 1).all()
    if k > 1:
        assert (lsb_seen >= 1).all()
        assert Kw % gw == 0          # k > 1: the last k-group is whole (no LSB past the end)
        rw = k1_stage_rows(plan.nt, pw)              # a stage's lsb rows fit its buffer
        for w0 in range(0, Kw, gw):
            rows = ((pw * w0 // k) >> 5, ((pw * (w0 + rw) - 1) // k) >> 5)
            assert rows[1] - rows[0] + 1 <= k1_lsb_rows(rw, k, pw)
    assert plan.tn * plan.col_tiles >= N and 8 * plan.nt * plan.row_tiles >= B


@pytest.mark.parametrize("scheme", WIDE_SCHEMES)
@pytest.mark.parametrize("arch,name,K,N", QWEN, ids=[n for _, n, _, _ in QWEN])
def test_k1b_wide_plan_fills_the_card_at_decode(scheme, arch, name, K, N):
    """fp8, fp6 and fp5 at Qwen2-7B's projections, B = 8: at least one CTA
    per SM, at least 64 for wk/wv."""
    lay = make_layout(get_scheme(scheme))
    plan = plan_ams_matmul(8, lay.padded_k(K) // lay.per_word, N, container="planes", k=1,
                           per_word=lay.per_word)
    assert plan.ctas >= (64 if name in ("wk", "wv") else SMS), plan


# ------------------------------------------------------------------ K4
@pytest.mark.parametrize("b0,b1,cluster", [(0, 1024, 8), (0, 1000, 8), (0, 5, 8), (0, 33, 3),
                                           (2048, 4096, 2), (512, 700, 5), (0, 64, 1),
                                           (100, 100, 4)])
def test_attention_shares_cover_every_key_once(b0, b1, cluster):
    shares = attention_shares(b0, b1, cluster)
    assert len(shares) == cluster
    covered = np.zeros(max(b1, 1), dtype=int)
    for i, (lo, hi) in enumerate(shares):
        assert b0 <= lo <= hi <= b1
        if hi > lo and hi < b1:
            assert (hi - lo) % 32 == 0            # whole tiles but the last
        if i:
            assert lo == shares[i - 1][1]         # contiguous, in rank order
        covered[lo:hi] += 1
    assert (covered[b0:b1] == 1).all() and covered[:b0].sum() == 0


def test_k4_plan_fills_the_card_at_decode():
    """8 slots x 4 kv heads at decode: 256 CTAs; the cluster is the same at
    every slot count and row count (a row's keys split by the block alone)."""
    plan = plan_contiguous_attention(8, 4, 7, 1024)     # Qwen2-7B: 8 slots x 4 kv heads
    assert plan.ctas(8, 4) >= 128 and plan.cluster <= MAX_CLUSTER
    assert {plan_contiguous_attention(b, 4, r, 1024).cluster
            for b in (1, 2, 8, 64) for r in (7, 35, 112)} == {plan.cluster}


SERVED = [(slots, capacity, chunk) for slots in (4, 8) for capacity in (256, 512, 1024)
          for chunk in (1, 16)]


@pytest.mark.parametrize("slots,capacity,chunk", SERVED)
def test_k4_scores_fit_at_every_served_shape(slots, capacity, chunk):
    """Qwen2-7B (kv 4, g 7, hd 128) at the served slots, capacities and
    chunks, with the reference's block plan: one pass over the keys."""
    R = chunk * 7
    bk = reference_block_kv(rows=R, hd=128, hd_v=128, s_max=capacity)
    plan = plan_contiguous_attention(slots, 4, R, bk)
    assert plan.scores_fit and plan.score_keys >= plan.share_keys
    assert plan.share_keys * plan.cluster >= bk and 1 <= plan.cluster <= MAX_CLUSTER
    assert plan.row_tiles * ATT_ROWS >= R


def test_k4_plan_takes_two_passes_past_shared_memory():
    plan = plan_contiguous_attention(4, 2, 7, 16384)
    assert not plan.scores_fit and plan.score_keys == 64


def _split_walk(qf, k, v, lens, *, c, g, block_kv, cluster):
    """K4's split argument in plain torch: per (slot, head, tile of 16 rows)
    each rank forms the scores of its share of every block (the shares of
    `attention_shares` over the whole block, cut at the tile's last visible
    key, as the kernel takes them), the ranks share the block max, each sums p and
    bf16(p) . v over its share at that max, and the ranks' (l, acc) are added
    in rank order at the end."""
    B, kv_n, R, hd = qf.shape
    S = k.shape[1]
    out = torch.zeros((B, kv_n, R, v.shape[-1]), dtype=torch.float32)
    row_len = lens.reshape(B, c).repeat_interleave(g, dim=1)            # [B, R]
    for b in range(B):
        for h in range(kv_n):
            for r0 in range(0, R, ATT_ROWS):
                rows = slice(r0, min(R, r0 + ATT_ROWS))
                q = qf[b, h, rows]
                ln = row_len[b, rows]
                nkeys = min(int(ln.max()), S)
                m = torch.full((q.shape[0], 1), NEG_CLAMP)
                l_r = [torch.zeros((q.shape[0], 1)) for _ in range(cluster)]
                acc_r = [torch.zeros((q.shape[0], v.shape[-1])) for _ in range(cluster)]
                for b0 in range(0, nkeys, block_kv):
                    shares = [(min(lo, nkeys), min(hi, nkeys))
                              for lo, hi in attention_shares(b0, min(b0 + block_kv, S), cluster)]
                    scores = []
                    for lo, hi in shares:
                        s = q @ k[b, lo:hi, h].float().T
                        s = s + torch.where(torch.arange(lo, hi)[None] < ln[:, None], 0.0,
                                            NEG_BIG)
                        scores.append(s)
                    bmax = torch.stack([s.amax(dim=-1) if s.shape[1] else
                                        torch.full((q.shape[0],), -math.inf)
                                        for s in scores]).amax(dim=0)[:, None]
                    m_new = torch.clamp(torch.maximum(m, bmax), min=NEG_CLAMP)
                    corr = torch.exp(m - m_new)
                    for i, ((lo, hi), s) in enumerate(zip(shares, scores)):
                        p = torch.exp(s - m_new)
                        l_r[i] = l_r[i] * corr + p.sum(dim=-1, keepdim=True)
                        pv = p.to(torch.bfloat16).float() @ v[b, lo:hi, h].float()
                        acc_r[i] = acc_r[i] * corr + pv
                    m = m_new
                acc, l = acc_r[0], l_r[0]
                for i in range(1, cluster):
                    acc, l = acc + acc_r[i], l + l_r[i]
                out[b, h, rows] = acc / torch.clamp(l, min=1e-20)
    return out


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("nblocks", [1, 2, 4])
@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 8])
def test_k4_split_walk_matches_the_plain_walk(cluster, nblocks, chunk):
    """The split changes only the f32 order: within K4's element rule
    (2^-7 + 1e-4) * A of the plain walk, A = sum bf16(p)|v| / l, and exact
    zeros on masked rows. Slot 1 sees 3 keys, so most ranks' shares hold
    no visible key; slot 2 is idle."""
    kv, g, hd, S = 2, 3, 16, 256
    block_kv = S // nblocks
    rng = np.random.default_rng(17 * cluster + nblocks + chunk)
    k = torch.from_numpy(rng.standard_normal((4, S, kv, hd), dtype=np.float32)).to(
        torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((4, S, kv, hd), dtype=np.float32)).to(
        torch.bfloat16)
    ends = np.array([S, 3, 0, 150])
    nvalid = np.minimum(np.array([chunk, max(chunk - 1, 1), 0, 1]), ends)
    j = np.arange(chunk)[None]
    lengths = np.where(j < nvalid[:, None], ends[:, None] - nvalid[:, None] + j + 1, 0)
    lens = torch.from_numpy(lengths.reshape(-1).astype(np.int32))
    qf = torch.from_numpy(rng.standard_normal((4, kv, chunk * g, hd), dtype=np.float32) / 4)
    kw = dict(c=chunk, g=g, block_kv=block_kv)
    got = _split_walk(qf, k, v, lens, cluster=cluster, **kw)
    want = contiguous_attention_plain(qf, k, v, lens, **kw)
    tol = (2 ** -7 + 1e-4) * contiguous_attention_plain(qf, k, v.abs(), lens, **kw)
    assert bool(((got - want).abs() <= tol).all())
    masked = torch.from_numpy(np.repeat(lengths == 0, g, axis=1))         # [B, c*g]
    assert bool((got.permute(0, 2, 1, 3)[masked] == 0).all())
    assert int(masked.sum()) > 0


# ------------------------------------------------------ K3 / K5p sub-tiles
PA_TILE, PA_WARPS = 32, 8


def _subtile_walk(qf, load, lens, block_table, *, page_size, c, g, pv_dtype, tile=PA_TILE):
    """The page-max contract on pages walked in sub-tiles, in plain torch:
    per page, pass 1 takes the scores of every sub-tile of ``tile`` tokens
    that a block of 8 rows can see (sub-tiles past every row of the block
    are skipped) and their max; pass 2 forms p at that max, sub-tile by
    sub-tile, sums it and its PV product in sub-tile order. Returns the output and, per page, bf16(p) of
    the sub-tiles walked ([B, kv, R, page] with -1 where none)."""
    B, kv_n, R, hd = qf.shape
    row_len = lens.reshape(B, c).repeat_interleave(g, dim=1)[:, None, :]   # [B, 1, R]
    block_len = torch.stack([row_len[..., r0:r0 + PA_WARPS].amax(dim=-1)
                             for r0 in range(0, R, PA_WARPS)], dim=-1)
    block_len = block_len.repeat_interleave(PA_WARPS, dim=-1)[..., :R]    # [B, 1, R]
    m = torch.full((B, kv_n, R, 1), NEG_CLAMP)
    l = torch.zeros_like(m)
    acc, ps = None, []
    for i in range(-(-int(lens.max()) // page_size)):
        kb, vb = load(block_table[:, i].long())
        s = torch.einsum("bhrd,bthd->bhrt", qf, kb)
        k_pos = i * page_size + torch.arange(page_size)
        s = s + torch.where(k_pos < row_len[..., None], 0.0, NEG_BIG)
        walked = (torch.arange(page_size) // tile * tile)[None, None, None, :] < \
            (block_len - i * page_size)[..., None]                            # [B, 1, R, page]
        tiles = range(0, page_size, tile)
        s_max = torch.stack([torch.where(walked[..., t0:t0 + tile], s[..., t0:t0 + tile],
                                         -torch.inf).amax(dim=-1) for t0 in tiles]).amax(dim=0)
        m_new = torch.clamp(torch.maximum(m, s_max[..., None]), min=NEG_CLAMP)
        corr = torch.exp(m - m_new)
        acc = torch.zeros((B, kv_n, R, vb.shape[-1])) if acc is None else acc * corr
        p_sum = torch.zeros_like(l)
        p_bits = torch.full(s.shape, -1.0)
        for t0 in tiles:
            w = walked[..., t0:t0 + tile]
            p = torch.where(w, torch.exp(s[..., t0:t0 + tile] - m_new), 0.0)
            p_sum = p_sum + p.sum(dim=-1, keepdim=True)
            pv = p.to(pv_dtype).float()
            acc = acc + torch.einsum("bhrt,bthd->bhrd", pv, vb[:, t0:t0 + tile])
            p_bits[..., t0:t0 + tile] = torch.where(w, pv, -1.0)
        l = l * corr + p_sum
        m = m_new
        ps.append(p_bits)
    return acc / torch.clamp(l, min=1e-20), ps


@pytest.mark.parametrize("pv", ["f32", "bf16"])
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("page", [48, 64, 128])
def test_paged_subtile_walk_matches_the_plain_walk(page, chunk, pv):
    """Pages wider than one sub-tile of 32 tokens (48: a ragged second
    sub-tile): forming the page's max over every sub-tile before any p gives
    the plain walk's bf16(p) bit for bit (the same walk with one tile per
    page), and outputs within the kernels' tolerance (K2: 1e-4 of max |y|;
    K3: 2^-8 max |v| + 1e-4 max |y|); masked rows and the idle slot are
    exact zeros. Slot 1 sees 3 keys; slot 3's last sub-tile is skipped."""
    kv, g, hd, MP = 2, 3, 16, 4
    pv_dtype = torch.float32 if pv == "f32" else torch.bfloat16
    rng = np.random.default_rng(page + chunk)
    B, P = 4, 4 * MP
    pool = {n: torch.from_numpy(rng.standard_normal((P, page, kv, hd), dtype=np.float32))
            .to(torch.bfloat16).float() for n in ("k", "v")}
    bt = torch.from_numpy(rng.permutation(P).reshape(B, MP).astype(np.int32))
    ends = np.array([MP * page, 3, 0, 2 * page + 5])
    nvalid = np.minimum(np.array([chunk, max(chunk - 1, 1), 0, 1]), ends)
    j = np.arange(chunk)[None]
    lengths = np.where(j < nvalid[:, None], ends[:, None] - nvalid[:, None] + j + 1, 0)
    lens = torch.from_numpy(lengths.reshape(-1).astype(np.int32))
    qf = torch.from_numpy(rng.standard_normal((B, kv, chunk * g, hd), dtype=np.float32) / 2)

    def load(pg):
        return pool["k"][pg], pool["v"][pg]

    kw = dict(page_size=page, c=chunk, g=g, pv_dtype=pv_dtype)
    got, p_tiles = _subtile_walk(qf, load, lens, bt, **kw)
    _, p_pages = _subtile_walk(qf, load, lens, bt, tile=page, **kw)
    for pt, pp in zip(p_tiles, p_pages):
        walked = pt >= 0
        assert torch.equal(pt[walked].view(torch.int32), pp[walked].view(torch.int32))
        assert bool((pp[~walked & (pp >= 0)] == 0).all())      # skipped keys: p is 0
    want = _paged_online_softmax(qf, load, lens, bt, **kw)
    ymax = float(want.abs().max())
    tol = 1e-4 * ymax if pv == "f32" else 2 ** -8 * float(pool["v"].abs().max()) + 1e-4 * ymax
    assert float((got - want).abs().max()) <= tol
    masked = torch.from_numpy(np.repeat(lengths == 0, g, axis=1))            # [B, c*g]
    assert int(masked.sum()) > 0
    assert bool((got.permute(0, 2, 1, 3)[masked] == 0).all())


# ------------------------------------------------------------------ K5
MLA_SERVED = [(slots, capacity, chunk) for slots in (1, 4, 8) for capacity in (256, 512, 1024)
              for chunk in (1, 16)]


@pytest.mark.parametrize("slots,capacity,chunk", MLA_SERVED)
def test_k5_plan_covers_every_key_once_and_stays_resident(slots, capacity, chunk):
    """MiniCPM3-4B (one stream, 40 heads, hd 288 / 256) with the reference's
    block plan at the served slots, capacities and chunks: the ranks' shares
    cover every key of a block once, every share stays resident in the
    4-tile ring (one read of each key per block), the row groups hold every
    folded row, at most 8 ranks (the portable cluster)."""
    R = 40 * chunk
    bk = reference_block_kv(rows=R, hd=288, hd_v=256, s_max=capacity)
    plan = plan_mla_attention(slots, 1, R, bk)
    assert 1 <= plan.cluster <= MAX_CLUSTER and plan.resident
    assert plan.share_keys <= MLA_RESIDENT_KEYS and plan.row_groups * MLA_ROWS >= R
    for b1 in (bk, bk - 1, 1):                   # a full block and ragged visible ends
        covered = np.zeros(bk, dtype=int)
        for lo, hi in attention_shares(0, bk, plan.cluster):   # cut where the keys end
            lo, hi = min(lo, b1), min(hi, b1)
            assert hi - lo <= plan.share_keys
            covered[lo:hi] += 1
        assert (covered[:b1] == 1).all() and covered[b1:].sum() == 0


def test_k5_plan_fills_the_card_at_decode():
    """8 slots at decode (one row group each): 64 CTAs at the portable cluster
    of 8, which one slot alone does not exceed either (one CTA per SM: ~190
    KB of shared memory each), the same at every slot and row count; a long
    block streams its keys twice."""
    assert plan_mla_attention(8, 1, 40, 1024).ctas(8, 1) == 64
    assert plan_mla_attention(1, 1, 40, 1024).cluster == MAX_CLUSTER
    assert plan_mla_attention(8, 1, 640, 1024).ctas(8, 1) >= SMS
    assert not plan_mla_attention(8, 1, 40, 4096).resident
    assert {plan_mla_attention(b, 1, r, 1024).cluster
            for b in (1, 2, 8, 64) for r in (40, 200, 640)} == {MAX_CLUSTER}


def _mla_split_walk(qf, cache, lens, *, c, g, block_kv, hd_v, cluster, local_max=False):
    """K5's split argument in plain torch: per (slot, head, group of 48
    rows) the block's scores are formed once; each rank takes its share
    (`attention_shares`), the ranks share the block max (``local_max``: the
    mutation, each rank its own max, rescaled when the ranks meet), p =
    exp(s - m_new) is rounded to bf16 for p . v (v = the keys' first hd_v
    columns), and the ranks' (l, acc) are added in rank order. Returns the
    output and bf16(p) of every block ([B, kv, R, S], -1 where not walked)."""
    B, kv_n, R, hd = qf.shape
    S = cache.shape[1]
    out = torch.zeros((B, kv_n, R, hd_v))
    p_all = torch.full((B, kv_n, R, S), -1.0)
    row_len = lens.reshape(B, c).repeat_interleave(g, dim=1)             # [B, R]
    for b in range(B):
        for h in range(kv_n):
            for r0 in range(0, R, MLA_ROWS):
                rows = slice(r0, min(R, r0 + MLA_ROWS))
                q = qf[b, h, rows]
                ln = row_len[b, rows]
                n = q.shape[0]
                m = torch.full((n, 1), NEG_CLAMP)
                ms = [m.clone() for _ in range(cluster)]
                l_r = [torch.zeros((n, 1)) for _ in range(cluster)]
                acc_r = [torch.zeros((n, hd_v)) for _ in range(cluster)]
                for b0 in range(0, min(int(ln.max()), S), block_kv):
                    b1 = min(b0 + block_kv, int(ln.max()), S)
                    kb = cache[b, b0:b1, h].float()
                    s = q @ kb.T + torch.where(torch.arange(b0, b1)[None] < ln[:, None], 0.0,
                                               NEG_BIG)
                    m_new = torch.clamp(torch.maximum(m, s.amax(dim=-1, keepdim=True)),
                                        min=NEG_CLAMP)
                    for i, (lo, hi) in enumerate(attention_shares(b0, min(b0 + block_kv, S),
                                                                  cluster)):
                        lo, hi = min(lo, b1), min(hi, b1)    # cut at the group's last key
                        sr = s[:, lo - b0:hi - b0]
                        mr = m_new
                        if local_max:
                            smax = sr.amax(dim=-1, keepdim=True) if hi > lo else ms[i]
                            mr = torch.clamp(torch.maximum(ms[i], smax), min=NEG_CLAMP)
                        corr = torch.exp((ms[i] if local_max else m) - mr)
                        p = torch.exp(sr - mr)
                        pb = p.to(torch.bfloat16).float()
                        l_r[i] = l_r[i] * corr + p.sum(dim=-1, keepdim=True)
                        acc_r[i] = acc_r[i] * corr + pb @ kb[lo - b0:hi - b0, :hd_v]
                        ms[i] = mr
                        p_all[b, h, rows, lo:hi] = pb
                    m = m_new
                acc, l = torch.zeros_like(acc_r[0]), torch.zeros_like(l_r[0])
                m_star = torch.stack(ms).amax(dim=0) if local_max else m
                for i in range(cluster):
                    w = torch.exp(ms[i] - m_star) if local_max else 1.0
                    acc, l = acc + w * acc_r[i], l + w * l_r[i]
                out[b, h, rows] = acc / torch.clamp(l, min=1e-20)
    return out, p_all


def _mla_case(kv, g, hd, S, chunk, seed):
    rng = np.random.default_rng(seed)
    cache = torch.from_numpy(rng.standard_normal((4, S, kv, hd), dtype=np.float32)).to(
        torch.bfloat16)
    ends = np.array([S, 3, 0, S // 2 + 7])
    nvalid = np.minimum(np.array([chunk, max(chunk - 1, 1), 0, 1]), ends)
    j = np.arange(chunk)[None]
    lengths = np.where(j < nvalid[:, None], ends[:, None] - nvalid[:, None] + j + 1, 0)
    lens = torch.from_numpy(lengths.reshape(-1).astype(np.int32))
    qf = torch.from_numpy(rng.standard_normal((4, kv, chunk * g, hd), dtype=np.float32)
                          / math.sqrt(hd))
    masked = torch.from_numpy(np.repeat(lengths == 0, g, axis=1))          # [B, c*g]
    return qf, cache, lens, masked


MLA_WALKS = [(1, 40, 288, 256, 256, 1, 256), (1, 40, 288, 256, 256, 2, 64),
             (1, 4, 48, 32, 160, 1, 160), (1, 4, 48, 32, 160, 4, 32),
             (2, 13, 20, 12, 96, 4, 48)]


@pytest.mark.parametrize("kv,g,hd,hd_v,S,chunk,block_kv", MLA_WALKS)
def test_k5_split_walk_matches_the_plain_walk(kv, g, hd, hd_v, S, chunk, block_kv):
    """The split changes only the f32 order of the sums: bf16(p) bit for bit
    the one-rank walk's (p formed at the cluster's block max), outputs within
    K5's element rule (2^-7 + 1e-4) * A of `contiguous_attention_mla_plain`,
    A = sum bf16(p)|v| / l; masked rows and the idle slot exact zeros.
    MiniCPM3-4B's widths (one and four key blocks, 40 heads: a row group of
    48 and, at chunk 2, a second) and small ones (13 heads x 4 queries: two
    row groups)."""
    qf, cache, lens, masked = _mla_case(kv, g, hd, S, chunk, hd + S + chunk)
    R = chunk * g
    plan = plan_mla_attention(4, kv, R, block_kv)
    kw = dict(c=chunk, g=g, block_kv=block_kv, hd_v=hd_v)
    got, p_split = _mla_split_walk(qf, cache, lens, cluster=max(plan.cluster, 3), **kw)
    _, p_one = _mla_split_walk(qf, cache, lens, cluster=1, **kw)
    assert torch.equal(p_split.view(torch.int32), p_one.view(torch.int32))
    want = contiguous_attention_mla_plain(qf, cache, lens, **kw)
    kw.pop("hd_v")
    tol = (2 ** -7 + 1e-4) * contiguous_attention_plain(
        qf, cache, cache[..., :hd_v].abs().contiguous(), lens, **kw)
    assert bool(((got - want).abs() <= tol).all())
    assert int(masked.sum()) > 0
    assert bool((got.permute(0, 2, 1, 3)[masked] == 0).all())


def test_k5_split_walk_mutation_is_caught():
    """Forming p at each rank's own running max (and rescaling when the ranks
    meet) moves bf16(p) off the plain walk's rounding points: the bit check
    of `test_k5_split_walk_matches_the_plain_walk` fails."""
    qf, cache, lens, _ = _mla_case(1, 40, 288, 256, 1, 7)
    kw = dict(c=1, g=40, block_kv=256, hd_v=256)
    _, p_bad = _mla_split_walk(qf, cache, lens, cluster=8, local_max=True, **kw)
    _, p_one = _mla_split_walk(qf, cache, lens, cluster=1, **kw)
    assert not torch.equal(p_bad.view(torch.int32), p_one.view(torch.int32))


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("slots,chunk,max_keys", [(8, 1, 512), (8, 1, 1024), (8, 16, 1024),
                                                  (4, 1, 256), (1, 1, 64), (8, 4, 40960)])
def test_k2_plan_covers_every_token_once(slots, chunk, max_keys):
    """Qwen2-7B (kv 4, g 7): the row tiles hold every folded row; for any
    count of visible tokens a row's shares (whole 32-token sub-tiles but
    the last, contiguous, in rank order) cover each token once, and the
    cluster has a rank for every share that holds tokens."""
    R = 7 * chunk
    plan = plan_paged_attention(slots, 4, R, max_keys)
    assert plan.rows in PAGED_ROW_TILES and plan.rows * plan.row_tiles >= R
    assert 1 <= plan.cluster <= MAX_CLUSTER
    for ntok in sorted({min(n, max_keys) for n in (0, 1, 31, 32, 33, 100, max_keys - 1, max_keys)}):
        covered = np.zeros(max(ntok, 1), dtype=int)
        for i, (lo, hi) in enumerate(paged_row_shares(ntok)):
            if hi > lo and hi < ntok:
                assert (hi - lo) % PAGED_SUB_KEYS == 0
            if hi > lo:
                assert i < plan.cluster, "a share without a rank"
            covered[lo:hi] += 1
        assert (covered[:ntok] == 1).all()


def test_k2_plan_fills_the_card_at_decode():
    """8 slots x 4 kv heads at decode: 256 CTAs (about two per SM); the
    cluster is the same at chunk 16 and at any slot count."""
    plan = plan_paged_attention(8, 4, 7, 1024)
    assert plan.rows == 8 and plan.ctas(8, 4) >= 2 * SMS - 32 and plan.cluster == MAX_CLUSTER
    assert plan_paged_attention(8, 4, 112, 1024).ctas(8, 4) >= 2 * SMS
    assert {plan_paged_attention(b, 4, r, 1024).cluster
            for b in (1, 2, 8, 64) for r in (7, 35, 112)} == {plan.cluster}


def _k2_split_walk(qf, load_tok, lens, *, c, g, max_keys, rows, unweighted=False,
                   tile_shares=False):
    """K2's split argument in plain torch: per (slot, head, tile of ``rows``
    rows) rank r walks the union of its rows' shares r (`paged_row_shares`
    of each row's visible tokens) sub-tile by sub-tile, each row seeing
    only its own share, with its own running max (p in f32); the ranks'
    (m, l, acc) merge in rank order: weights exp(m_r - m*) (``unweighted``:
    the mutation, none; ``tile_shares``: the mutation, every row of a tile
    split as its longest). ``load_tok(b, toks)`` -> (k, v) [len(toks), kv,
    hd]."""
    B, kv_n, R, hd = qf.shape
    out = torch.zeros_like(qf)
    row_len = lens.reshape(B, c).repeat_interleave(g, dim=1)             # [B, R]
    for b in range(B):
        for r0 in range(0, R, rows):
            sl = slice(r0, min(R, r0 + rows))
            ln = torch.clamp(row_len[b, sl], max=max_keys)
            shares = [paged_row_shares(int(n)) for n in ln]
            if tile_shares:
                shares = [[(min(lo, int(n)), min(hi, int(n)))
                           for lo, hi in paged_row_shares(int(ln.max()))] for n in ln]
            parts = []
            for rank in range(MAX_CLUSTER):
                own = [sh[rank] for sh in shares]
                live = [(lo, hi) for lo, hi in own if hi > lo]
                lo = min((a for a, _ in live), default=0)
                hi = max((e for _, e in live), default=0)
                a = torch.tensor([x for x, _ in own])[None, :, None]
                e = torch.tensor([x for _, x in own])[None, :, None]
                q = qf[b, :, sl]                                        # [kv, n, hd]
                m = torch.full((kv_n, q.shape[1], 1), NEG_CLAMP)
                l = torch.zeros_like(m)
                acc = torch.zeros_like(q)
                for t0 in range(lo, hi, PAGED_SUB_KEYS):
                    toks = torch.arange(t0, t0 + PAGED_SUB_KEYS)     # whole sub-tiles
                    kt, vt = load_tok(b, torch.clamp(toks, max=hi - 1))
                    # products summed per row (no batched matmul, whose order
                    # may follow the row count)
                    s = (q[:, :, None, :] * kt.permute(1, 0, 2)[:, None]).sum(dim=-1)
                    s = torch.where((toks[None, None] >= a) & (toks[None, None] < e), s,
                                    -torch.inf)
                    m_new = torch.clamp(torch.maximum(m, s.amax(dim=-1, keepdim=True)),
                                        min=NEG_CLAMP)
                    p = torch.exp(s - m_new)
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(dim=-1, keepdim=True)
                    acc = acc * corr + (p[..., None] * vt.permute(1, 0, 2)[:, None]).sum(dim=2)
                    m = m_new
                parts.append((m, l, acc))
            m_star = torch.stack([m for m, _, _ in parts]).amax(dim=0)
            num, den = torch.zeros_like(parts[0][2]), torch.zeros_like(parts[0][1])
            for m, l, acc in parts:
                w = 1.0 if unweighted else torch.exp(m - m_star)
                num, den = num + w * acc, den + w * l
            out[b, :, sl] = num / torch.clamp(den, min=1e-20)
    return out


def _k2_case(page, chunk, seed):
    """AMS-e2m2 pages (fp4.25) of 2 kv heads x hd 16, 4 slots x 4 pages;
    slot lengths 0, 1 and a page boundary - 1 / + 1 (chunked: the queries
    of a slot end there)."""
    from repro_torch.core.formats import get_scheme
    from repro_torch.core.kv_quant import quantize_kv
    from repro_torch.kernels.attention_template import restore_page

    kv, g, hd, MP, B = 2, 3, 16, 4, 4
    rng = np.random.default_rng(seed)
    scheme = get_scheme("fp4.25-e2m2")
    pool = {n: quantize_kv(torch.from_numpy(rng.standard_normal((B * MP, page, kv, hd),
                                                                  dtype=np.float32)), scheme)
            for n in ("k", "v")}
    bt = torch.from_numpy(rng.permutation(B * MP).reshape(B, MP).astype(np.int32))
    ends = np.array([0, 1, page - 1, 2 * page + 1])
    nvalid = np.minimum(np.array([0, 1, chunk, chunk]), ends)
    j = np.arange(chunk)[None]
    lengths = np.where(j < nvalid[:, None], ends[:, None] - nvalid[:, None] + j + 1, 0)
    lens = torch.from_numpy(lengths.reshape(-1).astype(np.int32))
    qf = torch.from_numpy(rng.standard_normal((B, kv, chunk * g, hd), dtype=np.float32) / 2)
    full = {n: restore_page(pool[n]["hi"], pool[n]["lsb"], pool[n]["scale"], scheme.base,
                            scheme.k, hd) for n in ("k", "v")}          # [P, page, kv, hd]

    def load_page(pg):
        return full["k"][pg], full["v"][pg]

    def load_tok(b, toks):
        pg = bt[b, toks // page].long()
        return full["k"][pg, toks % page], full["v"][pg, toks % page]

    masked = torch.from_numpy(np.repeat(lengths == 0, g, axis=1))          # [B, c*g]
    return qf, lens, bt, load_page, load_tok, masked, dict(c=chunk, g=g, max_keys=MP * page)


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("page", [16, 48, 64, 128])
def test_k2_split_walk_matches_the_plain_walk(page, chunk):
    """Each row's shares, each rank's own running max and the rank-order
    (m, l, acc) merge give `_paged_online_softmax`'s output within f32
    rounding (1e-4 of max |y|, K2's tolerance), with exact zeros for masked
    rows and the idle slot, pages of 16 (two per sub-tile) to 128 (four
    sub-tiles per page); a row's bits are the same in tiles of 8 and 16
    rows and alone, where its tile-mates see other tokens."""
    qf, lens, bt, load_page, load_tok, masked, kw = _k2_case(page, chunk, page + chunk)
    want = _paged_online_softmax(qf, load_page, lens, bt, page_size=page, c=kw["c"],
                                 g=kw["g"], pv_dtype=torch.float32)
    got = {rows: _k2_split_walk(qf, load_tok, lens, rows=rows, **kw) for rows in (1, 8, 16)}
    for y in got.values():
        assert float((y - want).abs().max()) <= 1e-4 * float(want.abs().max())
        assert bool((y.permute(0, 2, 1, 3)[masked] == 0).all())
    assert torch.equal(got[8], got[1]) and torch.equal(got[16], got[1])
    assert int(masked.sum()) > 0


def test_k2_split_walk_mutation_is_caught():
    """Merging the ranks' partials without their exp(m_r - m*) weights is
    far outside K2's tolerance."""
    qf, lens, bt, load_page, load_tok, _, kw = _k2_case(16, 1, 5)
    want = _paged_online_softmax(qf, load_page, lens, bt, page_size=16, c=1, g=kw["g"],
                                 pv_dtype=torch.float32)
    bad = _k2_split_walk(qf, load_tok, lens, rows=8, unweighted=True, **kw)
    assert float((bad - want).abs().max()) > 1e-4 * float(want.abs().max())


def test_k2_tile_shares_mutation_is_caught():
    """Splitting every row of a tile as its longest (the tokens the tile
    can see, not the row's own) gives a row other bits in a tile of 8 rows
    than alone where the chunk's lengths 255 and 257 take shares of 32 and
    64 tokens."""
    qf, lens, _, _, load_tok, _, kw = _k2_case(128, 3, 131)
    alone = _k2_split_walk(qf, load_tok, lens, rows=1, tile_shares=True, **kw)
    tiled = _k2_split_walk(qf, load_tok, lens, rows=8, tile_shares=True, **kw)
    assert not torch.equal(alone, tiled)


# ------------------------------------------------------------- K3 and K5p
@pytest.mark.parametrize("slots,chunk,max_keys,page", [(8, 1, 1024, 16), (8, 16, 1024, 16),
                                                       (8, 1, 512, 64), (4, 16, 256, 16),
                                                       (1, 1, 40960, 16), (8, 4, 4096, 4096),
                                                       (4, 1, 32, 4), (2, 1, 20000, 5000)])
def test_k3_plan_covers_every_token_once(slots, chunk, max_keys, page):
    """Qwen2-7B (kv 4, g 7): the 16-row tiles hold every folded row; at most
    8 ranks, no more than the 32-token tiles a slot holds; a segment holds
    whole pages, or parts of one page wider than cluster x score_keys
    tokens, and the segments' shares cover each visible token once, none
    wider than the score buffer."""
    R = 7 * chunk
    plan = plan_paged_bf16_attention(slots, 4, R, max_keys, page)
    assert plan.row_tiles * ATT_ROWS >= R and plan.row_tiles * ATT_ROWS - R < ATT_ROWS
    assert 1 <= plan.cluster <= min(MAX_CLUSTER, -(-max_keys // PAGED_SUB_KEYS))
    assert plan.score_keys % PAGED_SUB_KEYS == 0 and plan.score_keys <= K3_SCORE_KEYS_MAX
    cap = plan.cluster * plan.score_keys
    for ntok in (0, 1, page - 1, page + 1, max_keys - 1, max_keys):
        covered = np.zeros(max(ntok, 1), dtype=int)
        segs = paged_segments(ntok, page, plan.cluster, plan.score_keys)
        for s0, s1 in segs:
            assert s1 - s0 <= cap
            assert s0 % page == 0 if page <= cap else s0 // page == (s1 - 1) // page
            for lo, hi in attention_shares(s0, s1, plan.cluster):
                assert hi - lo <= plan.score_keys
                covered[lo:hi] += 1
        assert (covered[:ntok] == 1).all()


def test_k3_plan_fills_the_card_at_decode():
    """8 slots x 4 kv heads at decode: 256 CTAs of 128-key shares (about two
    per SM, as K2); the same 8 ranks at chunk 16 and at any slot count (a
    row's split does not follow B or the row tiles): 1792 CTAs; a page of
    4096 tokens takes all 8 ranks and one segment, a wider one segments of
    its own."""
    plan = plan_paged_bf16_attention(8, 4, 7, 1024, 16)
    assert plan.cluster == MAX_CLUSTER and plan.ctas(8, 4) == 256 and plan.score_keys == 128
    chunk = plan_paged_bf16_attention(8, 4, 112, 1024, 16)
    assert chunk.ctas(8, 4) >= 4 * SMS and chunk.score_keys <= 384
    assert {(p.cluster, p.score_keys) for p in (plan_paged_bf16_attention(b, 4, r, 1024, 16)
                                                for b in (1, 2, 8, 64) for r in (7, 35, 112))
            } == {(plan.cluster, plan.score_keys)}
    wide = plan_paged_bf16_attention(64, 4, 112, 4096, 4096)
    assert wide.cluster == MAX_CLUSTER and wide.cluster * wide.score_keys == 4096
    assert paged_segments(10000, 5000, MAX_CLUSTER, K3_SCORE_KEYS_MAX) == [
        (0, 4096), (4096, 5000), (5000, 9096), (9096, 10000)]


@pytest.mark.parametrize("slots,chunk,max_keys", [(8, 1, 1024), (8, 16, 1024), (1, 1, 64),
                                                  (4, 4, 40960), (4, 1, 32)])
def test_k5p_plan_keeps_every_share_resident(slots, chunk, max_keys):
    """MiniCPM3-4B (one stream, 40 heads): the 48-row groups hold every
    folded row; at most 8 ranks, no more than the 32-token tiles a slot
    holds; every share of a segment stays resident (128 keys); a bf16 page
    wider than 1024 tokens is walked in parts of 64 keys a rank."""
    R = 40 * chunk
    plan = plan_paged_mla_attention(slots, 1, R, max_keys)
    assert plan.row_groups * MLA_ROWS >= R
    assert 1 <= plan.cluster <= min(MAX_CLUSTER, -(-max_keys // PAGED_SUB_KEYS))
    for page in (16, 48, 128):
        if page > max_keys:
            continue
        for whole in (True, False):
            for s0, s1 in paged_segments(max_keys, page, plan.cluster, MLA_RESIDENT_KEYS, whole):
                assert all(hi - lo <= MLA_RESIDENT_KEYS
                           for lo, hi in attention_shares(s0, s1, plan.cluster))
    big = plan_paged_mla_attention(slots, 1, R, 8 * 1100)
    assert big.cluster == MAX_CLUSTER and big.cluster * MLA_RESIDENT_KEYS < 1100
    assert paged_segments(2200, 1100, big.cluster, MLA_RESIDENT_KEYS // 2)[:3] == [
        (0, 512), (512, 1024), (1024, 1100)]
    assert plan_paged_mla_attention(8, 1, 40, 1024).ctas(8, 1) == 64


def _paged_scores(qf, pool_k, lens, bt, *, page, c, g):
    """The masked scores of every folded row and token of every slot, [B,
    kv, R, MP * page] (-2e30 added past a row's length), from one einsum:
    the split walk and the plain walk below index the same f32 scores."""
    B, kv_n, R, hd = qf.shape
    T = bt.shape[1] * page
    toks = torch.arange(T)
    k = pool_k[bt[:, toks // page].long(), toks % page]                  # [B, T, kv, hd]
    row_len = lens.reshape(B, c).repeat_interleave(g, dim=1)            # [B, R]
    s = torch.einsum("bhrd,bthd->bhrt", qf, k)
    return s + torch.where(toks[None, None, None] < row_len[:, None, :, None], 0.0, NEG_BIG)


def _plain_page_p(S, page):
    """bf16(p) of the plain walk at every (row, token) of S: p = exp(s - m),
    m the clamped running max at the end of the token's page."""
    T = S.shape[-1]
    padded = torch.nn.functional.pad(S, (0, -T % page), value=-math.inf)
    pages = padded.reshape(*S.shape[:-1], -1, page).amax(dim=-1)
    m = torch.clamp(torch.cummax(pages, dim=-1).values, min=NEG_CLAMP)
    m = m.repeat_interleave(page, dim=-1)[..., :T]
    return torch.exp(S - m).to(torch.bfloat16).float()


def _paged_split_walk(S, V, lens, *, c, g, page, max_keys, cluster, share_keys, rows,
                      ams=False, local_max=False, unweighted=False, fixed=False):
    """K3's and K5p's split in plain torch, in the kernels' order. Per (slot,
    head, tile of ``rows`` rows) the visible tokens are walked in segments
    (`paged_segments`: whole pages on bf16 pages), each split into the
    ranks' shares (`attention_shares`). bf16 pages: each rank publishes its
    share's max and its first page's max; a rank's base is the running max
    of the segments walked and the lower ranks' share maxima, on its last
    page also the first-page maxima of the higher ranks that share it; m at
    a token is the max of the base and the rank's prefix max up to its
    page's last share token, and p is rounded to bf16 there (``local_max``:
    the mutation, the lower and higher ranks' maxima left out); a page
    wider than a segment takes its max whole in its first segment (the
    ranks also scan the page's rest), and p at it. AMS pages:
    each rank's own max, p in f32. Steps of 64 tokens: l += p w, acc +=
    (bf16(p) or p) w . v, w = exp(m - m_step), both rescaled by exp(m_prev -
    m_step); the ranks' (m, l, acc) merge in rank order with weights
    exp(m_r - m*) (``unweighted``: the mutation, none). ``fixed`` (K3): the
    segments and shares of all ``max_keys`` tokens, each share cut at the
    tile's last visible token; a row with no token in a share keeps its m
    there, and past its last token m stays its own. S [B, kv, R, T] the
    masked scores, V [B, T, kv, hd_v] the values in token order. Returns the
    output and p (bf16 pages: bf16(p)) of every walked (row, token), -1
    elsewhere."""
    B, kv_n, R, T = S.shape
    hd_v = V.shape[-1]
    out = torch.zeros((B, kv_n, R, hd_v))
    p_all = torch.full(S.shape, -1.0)
    row_len = lens.reshape(B, c).repeat_interleave(g, dim=1)             # [B, R]
    ninf = -math.inf
    for b in range(B):
        for h in range(kv_n):
            for r0 in range(0, R, rows):
                sl = slice(r0, min(R, r0 + rows))
                nr = sl.stop - r0
                ntok = min(int(row_len[b, sl].max()), max_keys)
                mrun = torch.full((nr,), ninf)
                m_r = [torch.full((nr,), NEG_CLAMP) for _ in range(cluster)]
                l_r = [torch.zeros(nr) for _ in range(cluster)]
                acc_r = [torch.zeros((nr, hd_v)) for _ in range(cluster)]
                wide = not ams and page > cluster * share_keys
                segs = paged_segments(max_keys if fixed else ntok, page, cluster, share_keys,
                                      not ams)
                for s0, s1 in (sg for sg in segs if sg[0] < ntok):
                    shares = [(min(lo, ntok), min(hi, ntok))
                              for lo, hi in attention_shares(s0, s1, cluster)]
                    s1 = min(s1, ntok)
                    s_sh = [S[b, h, sl, lo:hi] for lo, hi in shares]
                    smax = [x.amax(dim=-1) if x.shape[1] else torch.full((nr,), ninf)
                            for x in s_sh]
                    pend = min((s0 // page + 1) * page, ntok)
                    if wide and s0 % page == 0 and pend > s1:     # the page's rest
                        smax.append(S[b, h, sl, s1:pend].amax(dim=-1))
                    first = [x[:, :min((lo // page + 1) * page, hi) - lo].amax(dim=-1)
                             if hi > lo else torch.full((nr,), ninf)
                             for x, (lo, hi) in zip(s_sh, shares)]
                    for i, (lo, hi) in enumerate(shares):
                        n = hi - lo
                        if n == 0:
                            continue
                        s = s_sh[i]
                        if ams:
                            m = torch.clamp(torch.maximum(mrun, smax[i]), min=NEG_CLAMP)
                            m = m[:, None].expand(nr, n)
                        elif wide:
                            m = torch.stack([mrun, *smax]).amax(dim=0)
                            m = torch.clamp(m, min=NEG_CLAMP)[:, None].expand(nr, n)
                        else:
                            base, hx = mrun.clone(), torch.full((nr,), ninf)
                            if not local_max:
                                for q in range(i):
                                    base = torch.maximum(base, smax[q])
                                pe = ((hi - 1) // page + 1) * page
                                for q in range(i + 1, cluster):
                                    lq, hq = shares[q]
                                    if lq < hq and lq < pe:
                                        hx = torch.maximum(hx, first[q])
                            toks = torch.arange(lo, hi)
                            e = torch.clamp((toks // page + 1) * page, max=hi) - 1 - lo
                            last = (toks // page) == (hi - 1) // page
                            bb = torch.where(last[None], torch.maximum(base, hx)[:, None],
                                             base[:, None])
                            cm = torch.cummax(s, dim=-1).values
                            m = torch.clamp(torch.maximum(cm[:, e], bb), min=NEG_CLAMP)
                            if fixed:     # the kernel's m past a row's last token
                                e_row = torch.clamp(row_len[b, sl] - lo, max=n) - 1
                                j = torch.minimum(torch.arange(n)[None], e_row[:, None])
                                m = m.gather(1, j.clamp(min=0))
                                m = torch.where(e_row[:, None] < 0, m_r[i][:, None], m)
                        p = torch.exp(s - m)
                        pw = p if ams else p.to(torch.bfloat16).float()
                        p_all[b, h, sl, lo:hi] = pw
                        v = V[b, lo:hi, h]
                        for k0 in range(0, n, 64):
                            k1 = min(k0 + 64, n)
                            mstep = m[:, k1 - 1]
                            corr = torch.exp(m_r[i] - mstep)
                            w = torch.exp(m[:, k0:k1] - mstep[:, None])
                            l_r[i] = l_r[i] * corr + (p[:, k0:k1] * w).sum(dim=-1)
                            acc_r[i] = acc_r[i] * corr[:, None] + (pw[:, k0:k1] * w) @ v[k0:k1]
                            m_r[i] = mstep
                    mrun = torch.stack([mrun, *smax]).amax(dim=0)
                mx = torch.clamp(torch.stack(m_r).amax(dim=0), min=NEG_CLAMP)
                num, den = torch.zeros((nr, hd_v)), torch.zeros(nr)
                for i in range(cluster):
                    w = torch.ones(nr) if unweighted else torch.exp(m_r[i] - mx)
                    num, den = num + w[:, None] * acc_r[i], den + w * l_r[i]
                out[b, h, sl] = num / torch.clamp(den, min=1e-20)[:, None]
    return out, p_all


def _paged_split_case(kind, page, chunk, seed, kv=2, g=3, hd=16, hd_v=None):
    """5 slots x 4 pages of ``page`` tokens, lengths 0 (idle), 1, page - 1,
    page + 1 and full (chunked: the queries of a slot end there), kv heads
    of bf16 pages (``kind`` "bf16": values separate, or the stream's first
    ``hd_v`` columns when given) or AMS-e2m2 pages (``kind`` "ams", fp4.25:
    a stream, values its first ``hd_v`` restored columns). Returns qf, lens,
    bt, the masked scores, the values in token order, a page loader for
    `_paged_online_softmax` and the masked rows."""
    from repro_torch.core.formats import get_scheme
    from repro_torch.core.kv_quant import quantize_kv
    from repro_torch.kernels.attention_template import restore_page

    MP, B = 4, 5
    rng = np.random.default_rng(seed)
    x = {n: torch.from_numpy(rng.standard_normal((B * MP, page, kv, hd), dtype=np.float32))
         for n in ("k", "v")}
    if kind == "ams":
        scheme = get_scheme("fp4.25-e2m2")
        pl = quantize_kv(x["k"], scheme)
        k = restore_page(pl["hi"], pl["lsb"], pl["scale"], scheme.base, scheme.k, hd)
    else:
        k = x["k"].to(torch.bfloat16).float()
    v = k[..., :hd_v] if hd_v is not None else x["v"].to(torch.bfloat16).float()
    bt = torch.from_numpy(rng.permutation(B * MP).reshape(B, MP).astype(np.int32))
    ends = np.array([0, 1, page - 1, page + 1, MP * page])
    nvalid = np.minimum(np.array([0, 1, chunk, chunk, chunk]), ends)
    j = np.arange(chunk)[None]
    lengths = np.where(j < nvalid[:, None], ends[:, None] - nvalid[:, None] + j + 1, 0)
    lens = torch.from_numpy(lengths.reshape(-1).astype(np.int32))
    qf = torch.from_numpy(rng.standard_normal((B, kv, chunk * g, hd), dtype=np.float32)
                          / math.sqrt(hd))
    S = _paged_scores(qf, k, lens, bt, page=page, c=chunk, g=g)
    toks = torch.arange(MP * page)
    V = v[bt[:, toks // page].long(), toks % page]                       # [B, T, kv, hd_v]

    def load_page(pg):
        return k[pg], v[pg]

    masked = torch.from_numpy(np.repeat(lengths == 0, g, axis=1))          # [B, c*g]
    return qf, lens, bt, S, V, load_page, masked


def _split_plans(plan_cluster, plan_keys):
    """The plan's (cluster, share keys) and narrow ones: segments of one or
    a few pages, shares that split a page between ranks, pages wider than a
    segment (their parts walked at the whole page's max)."""
    return [(plan_cluster, plan_keys), (3, 64), (2, 32), (1, 32)]


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("page", [16, 48, 64, 128])
def test_k3_split_walk_matches_the_plain_walk(page, chunk):
    """K3's prefix-max split: bf16(p) bit for bit the plain walk's (p at the
    running max of its page), outputs within K3's rule (2^-8 max |v| + 1e-4
    max |y|) of `_paged_online_softmax`, exact zeros on masked rows and the
    idle slot; at the plan's cluster and score buffer and at narrow ones
    whose segments hold a few pages, whose shares split a page, or whose
    segments are narrower than a page."""
    qf, lens, bt, S, V, load_page, masked = _paged_split_case("bf16", page, chunk, page + chunk)
    kw = dict(c=chunk, g=3, page=page, max_keys=4 * page, rows=ATT_ROWS, fixed=True)
    want = _paged_online_softmax(qf, load_page, lens, bt, page_size=page, c=chunk, g=3,
                                 pv_dtype=torch.bfloat16)
    plan = plan_paged_bf16_attention(5, 2, 3 * chunk, 4 * page, page)
    p_plain = _plain_page_p(S, page)
    tol = 2 ** -8 * float(V.abs().max()) + 1e-4 * float(want.abs().max())
    for cluster, keys in _split_plans(plan.cluster, plan.score_keys):
        got, p_split = _paged_split_walk(S, V, lens, cluster=cluster, share_keys=keys, **kw)
        walked = p_split >= 0
        assert torch.equal(p_split[walked].view(torch.int32), p_plain[walked].view(torch.int32))
        assert float((got - want).abs().max()) <= tol
        assert bool((got.permute(0, 2, 1, 3)[masked] == 0).all())
    assert int(masked.sum()) > 0


def test_k3_split_walk_mutation_is_caught():
    """Rounding p at the rank-local max (without the lower ranks' share maxima
    and the higher ranks' first-page maxima) moves bf16(p) off the plain
    walk's rounding points: the bit check of
    `test_k3_split_walk_matches_the_plain_walk` fails."""
    qf, lens, bt, S, V, _, _ = _paged_split_case("bf16", 48, 4, 11)
    kw = dict(c=4, g=3, page=48, max_keys=192, rows=ATT_ROWS, cluster=3, share_keys=64,
              fixed=True)
    _, p_bad = _paged_split_walk(S, V, lens, local_max=True, **kw)
    walked = p_bad >= 0
    assert not torch.equal(p_bad[walked].view(torch.int32),
                           _plain_page_p(S, 48)[walked].view(torch.int32))


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("page", [16, 48, 64, 128])
@pytest.mark.parametrize("kind", ["bf16", "ams"])
def test_k5p_split_walk_matches_the_plain_walk(kind, page, chunk):
    """K5p's split with 48-row groups (40 heads on one stream, values its
    first columns; chunk 4: 160 rows in four groups, the last ragged). bf16
    pages: the prefix max of K3, bf16(p) bit for bit the plain walk's and
    outputs within K3's rule; AMS pages: each rank's own max and the
    rank-order merge, within 1e-4 of max |y| (K2's tolerance). Masked rows
    and the idle slot are exact zeros."""
    qf, lens, bt, S, V, load_page, masked = _paged_split_case(
        kind, page, chunk, 3 * page + chunk, kv=1, g=40, hd=24, hd_v=16)
    pv = torch.float32 if kind == "ams" else torch.bfloat16
    want = _paged_online_softmax(qf, load_page, lens, bt, page_size=page, c=chunk, g=40,
                                 pv_dtype=pv, hd_v=16)
    ymax = float(want.abs().max())
    tol = 1e-4 * ymax if kind == "ams" else 2 ** -8 * float(V.abs().max()) + 1e-4 * ymax
    plan = plan_paged_mla_attention(5, 1, 40 * chunk, 4 * page)
    kw = dict(c=chunk, g=40, page=page, max_keys=4 * page, rows=MLA_ROWS, ams=kind == "ams")
    for cluster, keys in _split_plans(plan.cluster, MLA_RESIDENT_KEYS):
        got, p_split = _paged_split_walk(S, V, lens, cluster=cluster, share_keys=keys, **kw)
        if kind == "bf16":
            walked = p_split >= 0
            assert torch.equal(p_split[walked].view(torch.int32),
                               _plain_page_p(S, page)[walked].view(torch.int32))
        assert float((got - want).abs().max()) <= tol
        assert bool((got.permute(0, 2, 1, 3)[masked] == 0).all())
    assert int(masked.sum()) > 0


def test_k5p_split_walk_mutations_are_caught():
    """bf16 pages: p at the rank-local max moves bf16(p) off the plain walk's;
    AMS pages: merging the ranks' partials without their exp(m_r - m*)
    weights is far outside K2's tolerance."""
    qf, lens, bt, S, V, _, _ = _paged_split_case("bf16", 64, 1, 5, kv=1, g=40, hd=24, hd_v=16)
    kw = dict(c=1, g=40, page=64, max_keys=256, rows=MLA_ROWS, cluster=3, share_keys=64)
    _, p_bad = _paged_split_walk(S, V, lens, local_max=True, **kw)
    walked = p_bad >= 0
    assert not torch.equal(p_bad[walked].view(torch.int32),
                           _plain_page_p(S, 64)[walked].view(torch.int32))
    qf, lens, bt, S, V, load_page, _ = _paged_split_case("ams", 16, 1, 6, kv=1, g=40, hd=24,
                                                         hd_v=16)
    want = _paged_online_softmax(qf, load_page, lens, bt, page_size=16, c=1, g=40,
                                 pv_dtype=torch.float32, hd_v=16)
    kw.update(page=16, max_keys=64, ams=True, share_keys=32)
    bad, _ = _paged_split_walk(S, V, lens, unweighted=True, **kw)
    assert float((bad - want).abs().max()) > 1e-4 * float(want.abs().max())


# ----------------------------------------------------- tensor-parallel shards
TP_PROJECTIONS = [(arch, *p) for arch in ("qwen2-7b", "llama4-scout-17b-16e")
                  for p in _projections(arch)]


def _k1_plans(K, N, scheme, B, **kw):
    """K1's (fp5.33) or K1b's (a planes scheme) plan of x [B, K] @ [K, N]."""
    lay = make_layout(get_scheme(scheme))
    Kw = lay.padded_k(K) // lay.per_word
    if lay.container == "fp533":
        return plan_ams_matmul(B, Kw, N, **kw)
    return plan_ams_matmul(B, Kw, N, container="planes", k=lay.scheme.k,
                           per_word=lay.per_word, **kw)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch,name,K,N", TP_PROJECTIONS,
                         ids=[f"{a}-{n}" for a, n, _, _ in TP_PROJECTIONS])
def test_k1_plan_of_an_n_shard_splits_k_as_the_whole_linear(tp, arch, name, K, N):
    """A rank's N / tp columns of a projection (`launch.sharding`) take the
    K split of the whole projection (``n_split=N``): the same cluster and
    words per rank, so each column sums its k-groups in the association it
    has at tp = 1, for K1 and K1b at B 1, 8 and 128; the column tiles cover
    the shard's N."""
    for scheme in ("fp5.33-e2m3", "fp4.25-e2m2"):
        for B in (1, 8, 128):
            whole = _k1_plans(K, N, scheme, B)
            shard = _k1_plans(K, N // tp, scheme, B, n_split=N)
            assert (shard.cluster, shard.split_words) == (whole.cluster, whole.split_words)
            assert shard.tn * shard.col_tiles >= N // tp > shard.tn * (shard.col_tiles - 1)


def test_k1_plan_of_a_shard_alone_can_split_k_otherwise():
    """Why the shard plan takes ``n_split``: planned on its own N, some
    Qwen2-7B shard splits K over another cluster than the whole projection
    (and would sum its columns in another order)."""
    differ = [(name, tp) for _, name, K, N in TP_PROJECTIONS[:7] for tp in (2, 4)
              if _k1_plans(K, N // tp, "fp5.33-e2m3", 8).split_words
              != _k1_plans(K, N, "fp5.33-e2m3", 8).split_words]
    assert differ


@pytest.mark.parametrize("arch", ["qwen2-7b", "llama4-scout-17b-16e"])
@pytest.mark.parametrize("tp", [2, 4])
def test_paged_plans_do_not_depend_on_the_kv_heads(arch, tp):
    """K2's and K3's plans take their cluster from the slot's tokens and the
    page, not the kv-head count: a rank's pool of kv / tp heads walks each
    head's tokens as the whole pool does."""
    cfg = get_config(arch)
    kv, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    for B, chunk, max_keys, page in ((8, 1, 512, 16), (8, 16, 512, 16), (3, 4, 4096, 64)):
        R = g * chunk
        assert (plan_paged_attention(B, kv // tp, R, max_keys)
                == plan_paged_attention(B, kv, R, max_keys))
        assert (plan_paged_bf16_attention(B, kv // tp, R, max_keys, page)
                == plan_paged_bf16_attention(B, kv, R, max_keys, page))

"""The Hopper launch plans of K1 and K4 (`repro_torch.kernels.tuning`), on the CPU.

`plan_ams_matmul` tiles K1's output and splits K over a thread-block
cluster; `plan_contiguous_attention` and `attention_shares` split K4's key
blocks over a cluster. These tests hold the plans to what the kernels rely
on (every word row and every key in exactly one split, k-group aligned K
splits, clusters of at most 8, enough CTAs to fill the card at the served
shapes, scores that fit in shared memory at every served shape), and check
the argument that makes K4's split exact up to the f32 order: a torch
emulation of the split walk (here, not in the package) against
`contiguous_attention_plain` within K4's element rule.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.attention_template import (  # noqa: E402
    NEG_BIG,
    NEG_CLAMP,
    contiguous_attention_plain,
)
from repro_torch.kernels.tuning import (  # noqa: E402
    ATT_ROWS,
    K1_GROUP_WORDS,
    MAX_CLUSTER,
    SMS,
    attention_shares,
    plan_ams_matmul,
    plan_contiguous_attention,
    reference_block_kv,
)


def _projections(arch):
    """(name, K, N) of every projection K1 serves for ``arch`` at full width."""
    cfg = get_config(arch)
    D = cfg.d_model
    if arch == "qwen2-7b":
        hd = cfg.head_dim
        return [("wq", D, cfg.num_heads * hd), ("wo", cfg.num_heads * hd, D),
                ("wk", D, cfg.num_kv_heads * hd), ("wv", D, cfg.num_kv_heads * hd),
                ("w_gate", D, cfg.d_ff), ("w_up", D, cfg.d_ff), ("w_down", cfg.d_ff, D)]
    H, dn, dr = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    return [("wq_a", D, cfg.q_lora_rank), ("wq_b", cfg.q_lora_rank, H * (dn + dr)),
            ("wkv_a", D, cfg.kv_lora_rank + dr), ("wo", H * cfg.v_head_dim, D),
            ("w_gate", D, cfg.d_ff), ("w_up", D, cfg.d_ff), ("w_down", cfg.d_ff, D)]


PROJECTIONS = [(arch, *p) for arch in ("qwen2-7b", "minicpm3-4b") for p in _projections(arch)]


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
    plan = plan_contiguous_attention(8, 4, 7, 1024)     # Qwen2-7B: 8 slots x 4 kv heads
    assert plan.ctas(8, 4) >= 128 and plan.cluster <= MAX_CLUSTER


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
    `attention_shares`), the ranks share the block max, each sums p and
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
                    shares = attention_shares(b0, min(b0 + block_kv, nkeys), cluster)
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

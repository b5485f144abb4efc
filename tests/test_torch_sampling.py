"""Port parity of seeded sampling: the port's threefry (`launch.prng`), the
top-k / top-p masks, the sampling epilogue and sampled engine streams,
against the JAX package on the CPU with the same numpy-made inputs.

Tolerances: keys, random bits and uniforms are bit-equal to
``jax.random``, and so is the Gumbel noise on CPU tensors: its two logs
are XLA's CPU expansion (`core.xla_math.log_f32`; torch's ``log`` differs
from it in the last bit on some inputs).
A categorical draw can differ from JAX's only at a near-tie,
where the top two ``gumbel + logit`` values lie within 1e-5: every differing
draw is checked to be one and counted. Masks, greedy tokens, done flags and
engine streams are exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cache import CacheConfig as JCacheConfig  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch import sampling as JS  # noqa: E402
from repro.launch.config import EngineConfig as JEngineConfig  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro_torch.cache import CacheConfig  # noqa: E402
from repro_torch.launch import prng  # noqa: E402
from repro_torch.launch import sampling as S  # noqa: E402
from repro_torch.launch.config import EngineConfig  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

SEEDS = [0, 1, 2 ** 31 - 1, -1]
RIDS = [0, 7, 10 ** 6]
NEAR_TIE = 1e-5


def jkey(seed, *folds):
    k = jax.random.PRNGKey(seed)
    for f in folds:
        k = jax.random.fold_in(k, f)
    return k


def tkey(seed, *folds):
    k = prng.PRNGKey(seed)
    for f in folds:
        k = prng.fold_in(k, f)
    return k


def u32(t):
    return t.numpy().astype(np.uint32)


# ------------------------------------------------------------------ prng
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_and_uniforms_bit_equal_to_jax(seed):
    """PRNGKey (negative seed included), fold_in up to rid 10^6, random
    bits (flat and 2-D iotas) and uniforms (one scalar per key and a row)
    equal jax.random's bit for bit; so does the batched fold of many keys."""
    np.testing.assert_array_equal(u32(prng.PRNGKey(seed)),
                                  np.asarray(jax.random.PRNGKey(seed), np.uint32))
    for rid in RIDS:
        for ngen in (0, 5, 4096):
            jk, tk = jkey(seed, rid, ngen), tkey(seed, rid, ngen)
            np.testing.assert_array_equal(u32(tk), np.asarray(jk, np.uint32))
            for shape in ((1000,), (3, 7)):
                np.testing.assert_array_equal(
                    u32(prng.random_bits(tk, shape)), np.asarray(jax.random.bits(jk, shape)))
            for shape in ((), (1000,)):
                a = np.asarray(jax.random.uniform(jk, shape))
                b = prng.uniform(tk, shape).numpy()
                np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    # a batch of keys folded with per-row data at once
    base = torch.stack([tkey(seed, rid) for rid in RIDS])
    data = torch.tensor([3, 0, 2 ** 31 + 5], dtype=torch.int64)
    want = [np.asarray(jax.random.fold_in(jkey(seed, rid), int(d)), np.uint32)
            for rid, d in zip(RIDS, data)]
    np.testing.assert_array_equal(u32(prng.fold_in(base, data)), np.stack(want))


def test_threefry_hash_bit_equal_to_jax():
    """The raw hash over random key and counter words."""
    from jax._src import prng as jprng
    rng = np.random.default_rng(3)
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jprng.threefry_2x32(jnp.asarray(k), jnp.asarray(x)))
    t = torch.from_numpy(x.astype(np.int64))
    y0, y1 = prng.threefry_2x32(torch.tensor(int(k[0])), torch.tensor(int(k[1])), t[:32], t[32:])
    np.testing.assert_array_equal(np.concatenate([u32(y0), u32(y1)]), want)


def test_gumbel_within_one_log_ulp_of_jax():
    """Full-vocabulary draws (now bit-equal: the CPU log is XLA's)."""
    for seed, rid in ((0, 0), (-1, 10 ** 6), (2 ** 31 - 1, 7)):
        a = np.asarray(jax.random.gumbel(jkey(seed, rid), (152064,)))
        b = prng.gumbel(tkey(seed, rid), (152064,)).numpy()
        assert np.abs(a - b).max() <= 4e-6
        np.testing.assert_array_equal(b.view(np.int32), a.view(np.int32))


def test_gumbel_bit_equal_to_jax_over_many_keys():
    """The Gumbel draw on CPU tensors equals jax.random.gumbel bit for bit
    (eager and jitted) over 256 keys of 4096 draws each, the seeds and
    request ids of the sampling key discipline; torch's own log differs in
    the last bit on some of them."""
    seeds = np.random.default_rng(0).integers(-2 ** 31, 2 ** 31 - 1, 64)
    jg = jax.jit(lambda k: jax.random.gumbel(k, (4096,)))
    torch_log_differs = 0
    for i, seed in enumerate(seeds):
        for rid in (0, 7, 10 ** 6, i):
            jk, tk = jkey(int(seed), rid), tkey(int(seed), rid)
            want = np.asarray(jg(jk))
            got = prng.gumbel(tk, (4096,)).numpy()
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
            if rid == 0:
                np.testing.assert_array_equal(
                    np.asarray(jax.random.gumbel(jk, (4096,))).view(np.int32), want.view(np.int32))
            u = prng.uniform(tk, (4096,), prng.TINY_F32, 1.0)
            plain = (-torch.log(-torch.log(u))).numpy()
            torch_log_differs += int((plain.view(np.int32) != want.view(np.int32)).sum())
    assert torch_log_differs > 0


def test_request_key_matches_reference():
    for seed in SEEDS:
        for rid in RIDS:
            np.testing.assert_array_equal(S.request_key(seed, rid), JS.request_key(seed, rid))


# ----------------------------------------------------------------- masks
def tied_logits(rng, shape):
    """Logits on a coarse grid: many ties, at the top-k cutoff as well."""
    return (np.round(rng.normal(size=shape) * 4) / 4).astype(np.float32)


@pytest.mark.parametrize("k", [0, 1, 5, 37])
@pytest.mark.parametrize("p", [1.0, 0.9, 0.5, 0.05])
def test_masks_equal_reference(k, p):
    """mask_top_k, mask_top_p and the one-sort masked_logits equal the
    reference's `_mask_top_k`, `_mask_top_p` and `_masked_logits` per row,
    ties at the cutoffs included."""
    rng = np.random.default_rng(k * 100 + int(p * 100))
    x = tied_logits(rng, (4, 300))
    kk = np.array([k, k, 0, max(k - 1, 0)], np.int32)
    pp = np.array([p, 1.0, p, p], np.float32)
    got_k = S.mask_top_k(torch.from_numpy(x), torch.from_numpy(kk)).numpy()
    got_p = S.mask_top_p(torch.from_numpy(x), torch.from_numpy(pp)).numpy()
    got = S.masked_logits(torch.from_numpy(x), torch.from_numpy(kk), torch.from_numpy(pp)).numpy()
    for b in range(4):
        np.testing.assert_array_equal(got_k[b], np.asarray(JS._mask_top_k(x[b], kk[b])))
        np.testing.assert_array_equal(got_p[b], np.asarray(JS._mask_top_p(x[b], pp[b])))
        np.testing.assert_array_equal(got[b], np.asarray(JS._masked_logits(x[b], kk[b], pp[b])))


# -------------------------------------------------------- sample_tokens
def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items() if k != "device"}


def check_near_ties(got, want, logits, batch):
    """Every row where the draws differ is sampled and a near-tie of JAX's
    own Gumbel-max: its top two ``gumbel + masked logit`` within 1e-5.
    Returns the count of such rows."""
    n = 0
    for b in np.flatnonzero(got != want):
        assert batch["temperature"][b] > 0, f"greedy row {b} differs"
        key = jax.random.fold_in(jnp.asarray(batch["key"][b]), int(batch["ngen"][b]))
        scaled = logits[b] / batch["temperature"][b]
        masked = np.asarray(JS._masked_logits(scaled, batch["top_k"][b], batch["top_p"][b]))
        z = np.sort(np.asarray(jax.random.gumbel(key, masked.shape)) + masked)
        assert z[-1] - z[-2] < NEAR_TIE, f"row {b}: not a near-tie ({z[-1] - z[-2]})"
        n += 1
    return n


@pytest.mark.parametrize("V", [512, 152064])
def test_sample_tokens_matches_reference(V):
    """Mixed greedy and sampled rows (temperature, top-k, top-p, distinct
    keys, stop ids, length caps): tokens and done flags equal the
    reference's `sample_tokens`, any differing draw a recorded near-tie."""
    rng = np.random.default_rng(V)
    B = 6
    batch = S.slot_batch(B)
    params = [S.SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=11),
              S.SamplingParams(),
              S.SamplingParams(temperature=1.3, seed=-1, stop_token_ids=(3, 4)),
              S.SamplingParams(temperature=0.5, top_p=0.5, seed=2 ** 31 - 1),
              S.SamplingParams(stop_token_ids=(1,)),
              S.SamplingParams(temperature=1.0, top_k=3, seed=5)]
    for s, sp in enumerate(params):
        S.fill_slot(batch, s, sp, S.request_key(sp.seed, 100 + s), max_tokens=4 + s)
    differing = 0
    for tick in range(4):
        batch["ngen"][:] = tick
        batch["device"]["ngen"].copy_(torch.from_numpy(batch["ngen"]))
        logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
        logits[4, 1] = logits[4].max() + 1                    # greedy row hits its stop id
        tok, done = S.sample_tokens(torch.from_numpy(logits), batch)
        jtok, jdone = JS.sample_tokens(jnp.asarray(logits), jax_batch(batch))
        tok, jtok = tok.numpy(), np.asarray(jtok)
        differing += check_near_ties(tok, jtok, logits, batch)
        same = tok == jtok
        np.testing.assert_array_equal(done.numpy()[same], np.asarray(jdone)[same])
        assert done.numpy()[4]
    print(f"V={V}: {differing} of {4 * B} draws differ from JAX's, each a near-tie")


def test_all_greedy_batch_runs_only_the_argmax(monkeypatch):
    """An all-greedy batch never reaches the draw (the host picks the
    branch from its numpy temperatures); a sampled row in the batch does."""
    calls = []
    monkeypatch.setattr(S.prng, "categorical", lambda *a: calls.append(1) or a[1].argmax(-1))
    batch = S.slot_batch(2)
    logits = torch.randn(2, 64)
    S.sample_tokens(logits, batch)
    assert not calls
    S.fill_slot(batch, 1, S.SamplingParams(temperature=0.7, seed=1), S.request_key(1, 0))
    S.sample_tokens(logits, batch)
    assert calls == [1]


# ------------------------------------------------------------- streams
PAGE, CAP = 8, 48


@pytest.fixture(scope="module")
def jax_params():
    return j_init_params(jax.random.PRNGKey(0), get_config("qwen2-7b").reduced())


@pytest.fixture(scope="module")
def np_params(jax_params):
    return jax.tree.map(np.asarray, jax_params)


def workload():
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, int(n)).astype(np.int32) for n in (13, 9, 17, 6)]
    params = [dict(temperature=0.8, top_k=50, top_p=0.95, seed=3), dict(),
              dict(temperature=1.0, seed=3), dict(temperature=0.7, top_p=0.9, seed=-1)]
    return prompts, params


def port_streams(np_params, slots=2, chunk=1, impl="kernel"):
    prompts, params = workload()
    eng = ServeEngine(EngineConfig(
        arch="qwen2-7b", reduced=True, scheme="fp5.33-e2m3", impl=impl, slots=slots,
        capacity=CAP, prefill_chunk=chunk, device="cpu",
        cache=CacheConfig(kind="paged_ams", page_size=PAGE,
                          impl="kernel" if impl == "kernel" else "ref")),
        params=params_from_numpy(np_params))
    hs = [eng.submit(p, 8, sampling=S.SamplingParams(**sp)) for p, sp in zip(prompts, params)]
    eng.run()
    return [list(h.tokens) for h in hs]


@pytest.mark.parametrize("chunk", [1, 4])
def test_sampled_streams_match_the_jax_engine(chunk, jax_params, np_params):
    """Reduced qwen2-7b, FP5.33 weights over AMS pages: seeded sampled
    streams (two requests sharing a seed, one greedy) equal the JAX
    engine's, through both impl pairs."""
    prompts, params = workload()
    jeng = JServeEngine(JEngineConfig(
        arch="qwen2-7b", reduced=True, scheme="fp5.33-e2m3", impl="fused_ref", slots=2,
        capacity=CAP, prefill_chunk=chunk, cache=JCacheConfig(kind="paged_ams", page_size=PAGE)),
        params=jax_params)
    hs = [jeng.submit(p, 8, sampling=JS.SamplingParams(**sp)) for p, sp in zip(prompts, params)]
    jeng.run()
    want = [list(h.tokens) for h in hs]
    assert want[0] != want[2]                 # one seed, two request ids
    for impl in ("kernel", "fused_ref"):
        assert port_streams(np_params, chunk=chunk, impl=impl) == want, impl


def test_sampled_streams_replay_across_restarts_slots_and_chunks(np_params):
    base = port_streams(np_params)
    assert port_streams(np_params) == base
    assert port_streams(np_params, slots=1) == base
    assert port_streams(np_params, slots=3, chunk=4) == base

"""The port's engine step as the card captures it, checked on the CPU.

On the card every engine tick replays a CUDA graph of the step
(`launch.steps.GraphedStep`), and a capture fails on any op that waits on
the device or copies from host memory. These tests hold the shared code to
that on CPU tensors:

  * `cache.pool.paged_insert` writes every entry with no boolean mask and
    no host sync, bit-equal to the boolean-mask insert it replaced (kept
    here as the oracle), idle slots with stale block tables included;
  * one engine tick of each served cache kind (AMS pages, bf16 pages,
    contiguous GQA, contiguous MLA, Mamba's state caches) runs under a
    dispatch mode that fails on host syncs, boolean indexing and tensors
    made from host data; the
    kernels' plain versions, which never run on the card's main path, may
    sync (the guard pauses inside them);
  * the capture's warm-up (every slot idle) leaves every cache byte as it
    was, the step's inputs are the same tensors on every tick, and a tick
    that prefills runs the full step chunk;
  * the launch counts a capture moved are added once per replay.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.cache import CacheConfig, make_gqa_page_pool, paged_insert  # noqa: E402
from repro_torch.core.formats import get_scheme  # noqa: E402
from repro_torch.core.kv_quant import quantize_kv  # noqa: E402
from repro_torch.kernels import attention_template as T  # noqa: E402
from repro_torch.kernels.build import KernelCount, add_counts, recorded_counts  # noqa: E402
from repro_torch.launch import sampling as S  # noqa: E402
from repro_torch.launch.config import EngineConfig  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402
from repro_torch.launch.steps import run_step  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402

PAGE, KV, HD = 4, 2, 16


# ------------------------------------------------------------ paged insert
def boolean_mask_insert(pool, k_new, v_new, pos, block_table, ccfg, nvalid):
    """The insert `paged_insert` replaced: boolean-mask indexing (one
    nonzero and one device-to-host copy per index on the card)."""
    c = k_new.shape[1]
    j = torch.arange(c, dtype=torch.int32)[None, :]
    p = pos[:, None] + j
    ok = (pos[:, None] >= 0) & (j < nvalid[:, None])
    logical = torch.clamp(torch.div(p, ccfg.page_size, rounding_mode="floor"),
                          0, block_table.shape[1] - 1)
    page = torch.take_along_dim(block_table, logical.long(), dim=1)
    off = torch.clamp(torch.remainder(p, ccfg.page_size), 0, ccfg.page_size - 1)
    page, off = page[ok].long(), off[ok].long()
    for name, new in (("k", k_new), ("v", v_new)):
        if not ccfg.quantized:
            pool[name][page, off] = new[ok].to(pool[name].dtype)
            continue
        q = quantize_kv(new, get_scheme(ccfg.kv_scheme), ccfg.kv_strategy)
        for pl in ("hi", "lsb", "scale"):
            pool[name][pl][page, off] = q[pl][ok]
    return pool


def insert_ticks(c):
    """(pos, nvalid, block_table) per tick on 4 slots: slot 3 idle with a
    stale block-table row naming pages that slots 0 and 1 write in the same
    ticks, slot 2 idle then admitted, entries past nvalid, and one tick in
    which every slot is idle."""
    bt = np.array([[3, 5, 7, 9], [2, 4, 6, 8], [10, 11, 12, 13], [3, 4, 5, 2]], np.int32)
    ticks = []
    for t in range(6):
        pos = np.array([t * c, 1 + t * c, -1 if t < 3 else (t - 3) * c, -1], np.int32)
        nvalid = np.array([c, max(c - 1, 1), c if t >= 3 else 0, 0], np.int32)
        ticks.append((pos, nvalid, bt))
    ticks.append((np.full(4, -1, np.int32), np.zeros(4, np.int32), bt))
    return ticks


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("kind", ["paged_ams", "paged_bf16"])
def test_paged_insert_bit_equal_to_boolean_mask_insert(kind, c):
    ccfg = CacheConfig(kind=kind, page_size=PAGE, num_pages=14, max_pages_per_seq=4,
                       kv_scheme="fp4.25-e2m2")
    got, want = make_gqa_page_pool(ccfg, KV, HD), make_gqa_page_pool(ccfg, KV, HD)
    gen = torch.Generator().manual_seed(c)
    for leaf_a, leaf_b in zip(tree_leaves(got), tree_leaves(want)):   # nonzero old bytes
        fill = torch.randint(-100, 100, leaf_a.shape, generator=gen).to(leaf_a.dtype)
        leaf_a.copy_(fill)
        leaf_b.copy_(fill)
    for pos, nvalid, bt in insert_ticks(c):
        k = torch.randn((4, c, KV, HD), generator=gen).to(torch.bfloat16)
        v = torch.randn((4, c, KV, HD), generator=gen).to(torch.bfloat16)
        pos_t, nv_t, bt_t = (torch.from_numpy(a) for a in (pos, nvalid, bt))
        paged_insert(got, k, v, pos_t, bt_t, ccfg, nvalid=nv_t)
        boolean_mask_insert(want, k, v, pos_t, bt_t, ccfg, nv_t)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("kind", ["paged_ams", "paged_bf16"])
def test_paged_insert_default_nvalid_and_all_idle_tick(kind):
    """Without nvalid every entry of an active slot is written; a tick with
    every slot idle leaves the pool's bytes as they were."""
    ccfg = CacheConfig(kind=kind, page_size=PAGE, num_pages=8, max_pages_per_seq=4)
    got, want = make_gqa_page_pool(ccfg, KV, HD), make_gqa_page_pool(ccfg, KV, HD)
    bt = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    k = torch.randn((2, 3, KV, HD)).to(torch.bfloat16)
    pos = torch.tensor([2, -1], dtype=torch.int32)
    paged_insert(got, k, -k, pos, bt, ccfg)
    boolean_mask_insert(want, k, -k, pos, bt, ccfg, torch.tensor([3, 0], dtype=torch.int32))
    before = [t.clone() for t in tree_leaves(got)]
    assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(before, tree_leaves(want)))
    paged_insert(got, k, k, torch.tensor([-1, -1], dtype=torch.int32), bt, ccfg)
    assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(before, tree_leaves(got)))


# ----------------------------------------------------------- no-sync guard
class NoSyncGuard(TorchDispatchMode):
    """Fails on ops that wait on the device or copy host data in: a tensor
    read back as a scalar, nonzero / masked_select, boolean-mask index or
    index_put, and a tensor made from host data (``lift_fresh``). The
    kernels' plain versions pause it (`paused`)."""

    FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
                 "aten.lift_fresh")

    def __init__(self):
        super().__init__()
        self.paused = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.ops += 1
            name = func.overloadpacket._qualified_op_name.replace("::", ".")
            if name in self.FORBIDDEN:
                raise AssertionError(f"{name} inside the engine step")
            if name in ("aten.index", "aten.index_put_", "aten.index_put"):
                if any(i is not None and i.dtype == torch.bool for i in args[1]):
                    raise AssertionError(f"{name} with a boolean mask inside the engine step")
        return func(*args, **(kwargs or {}))


PLAIN_VERSIONS = ("paged_attention_ams_plain", "paged_attention_bf16_plain",
                  "paged_attention_stream_bf16_plain", "paged_attention_stream_ams_plain",
                  "contiguous_attention_plain", "contiguous_attention_mla_plain")


@pytest.fixture
def guard(monkeypatch):
    g = NoSyncGuard()

    def pausing(fn):
        def inner(*a, **kw):
            g.paused += 1
            try:
                return fn(*a, **kw)
            finally:
                g.paused -= 1
        return inner

    for name in PLAIN_VERSIONS:
        monkeypatch.setattr(T, name, pausing(getattr(T, name)))
    return g


# the four served cache kinds, by (arch, cache kind)
KINDS = [("qwen2-7b", "paged_ams"), ("qwen2-7b", "paged_bf16"), ("qwen2-7b", "contiguous"),
         ("minicpm3-4b", "contiguous")]
KIND_IDS = ["ams-pages", "bf16-pages", "contiguous-gqa", "contiguous-mla"]


def engine(arch, kind, impl="kernel", chunk=4):
    return ServeEngine(EngineConfig(
        arch=arch, reduced=True, impl=impl, slots=3, capacity=32, prefill_chunk=chunk,
        device="cpu", cache=CacheConfig(kind=kind, page_size=8,
                                        impl="kernel" if impl == "kernel" else "ref")))


def prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (11, 6, 14)]


def warm_up(eng):
    """What the capture's warm-up does on the card: one step with every
    slot idle (it fills the constant tables the step reads)."""
    eng.inputs.set_idle()
    eng.device_step(eng.step_chunk)


@pytest.mark.parametrize("impl", ["kernel", "fused_ref"])
@pytest.mark.parametrize("arch,kind", KINDS, ids=KIND_IDS)
def test_engine_step_has_no_host_sync(arch, kind, impl, guard):
    """Every tick of a served run, prefill and decode widths, through the
    impls the card serves (kernel, and the consistency runs' fused_ref /
    ref), runs its step under the guard; streams equal an unguarded run."""
    eng, plain = engine(arch, kind, impl), engine(arch, kind, impl)
    warm_up(eng)
    inner, widths = eng.device_step, set()

    def guarded(width, eager=False):
        widths.add(width)
        with guard:
            return inner(width, eager=eager)

    eng.device_step = guarded
    hs = [eng.submit(p, 4) for p in prompts()]
    eng.run()
    want = [plain.submit(p, 4) for p in prompts()]
    plain.run()
    assert [h.tokens for h in hs] == [h.tokens for h in want]
    assert widths == {1, 4} and guard.ops > 0


def feature_engine(arch, kind, feature):
    return ServeEngine(EngineConfig(
        arch=arch, reduced=True, impl="kernel", slots=3, capacity=48, prefill_chunk=4,
        speculate_k=0 if feature == "sampled" else 3, device="cpu",
        cache=CacheConfig(kind=kind, page_size=8, impl="kernel")))


@pytest.mark.parametrize("feature", ["sampled", "speculative", "both"])
@pytest.mark.parametrize("arch,kind", [KINDS[0], KINDS[2]], ids=[KIND_IDS[0], KIND_IDS[2]])
def test_sampled_and_speculative_steps_have_no_host_sync(arch, kind, feature, guard):
    """The sampled epilogue (threefry keys, masks, Gumbel draws) and the
    speculative step (verify, and the rollback of rejected drafts through
    `cache.pool.paged_truncate` or `models.attention.cache_truncate_chunk`)
    run every tick under the guard: no host sync, no boolean mask, no
    tensor made from host data; streams equal an unguarded run."""
    eng, plain = feature_engine(arch, kind, feature), feature_engine(arch, kind, feature)
    warm_up(eng)
    inner, seen = eng.device_step, []

    def guarded(width, eager=False):
        seen.append((width, S.any_sampled(eng.samp)))
        with guard:
            return inner(width, eager=eager)

    eng.device_step = guarded
    rng = np.random.default_rng(1)
    prompts = [np.tile(rng.integers(0, 512, 4), 4).astype(np.int32) for _ in range(3)]
    samp = [S.SamplingParams(temperature=0.9, top_k=30, top_p=0.9, seed=i)
            if feature != "speculative" and i != 1 else None for i in range(3)]
    hs = [eng.submit(p, 10, sampling=sp) for p, sp in zip(prompts, samp)]
    eng.run()
    want = [plain.submit(p, 10, sampling=sp) for p, sp in zip(prompts, samp)]
    plain.run()
    assert [h.tokens for h in hs] == [h.tokens for h in want]
    assert guard.ops > 0 and {w for w, _ in seen} == {1, eng.step_chunk}
    assert any(sp for _, sp in seen) == (feature != "speculative")
    if feature != "sampled":
        assert eng.stats()["spec_proposed"] > 0


@pytest.mark.parametrize("arch,kind", [("internvl2-1b", "paged_ams"),
                                       ("internvl2-1b", "contiguous"),
                                       ("musicgen-medium", "paged_ams")])
def test_zoo_step_has_no_host_sync(arch, kind, guard):
    """The zoo's engines under the guard every tick: a VLM (reduced
    internvl2-1b) feeds each request's prefix embeddings through the step's
    embeds override, an f32 view of the same staged buffer as the int32
    inputs (one copy per tick); an audio decoder (reduced musicgen-medium)
    runs its GELU MLP, whose constants are a device table. Streams equal an
    unguarded run."""
    def zoo():
        return ServeEngine(EngineConfig(
            arch=arch, reduced=True, impl="kernel", slots=3, capacity=40, prefill_chunk=4,
            device="cpu", cache=CacheConfig(kind=kind, page_size=8, impl="kernel")))
    eng, plain = zoo(), zoo()
    ins = eng.inputs
    n_prefix = eng.cfg.num_prefix_embeds
    if n_prefix:
        assert ins.dev["embeds"].dtype == torch.float32
        assert ins.dev["embeds"].shape == (3, 4, 128)
        assert (ins.dev["embeds"].untyped_storage().data_ptr()
                == ins.dev_buf.untyped_storage().data_ptr())
    else:
        assert "embeds" not in ins.dev
    warm_up(eng)
    inner, widths = eng.device_step, set()

    def guarded(width, eager=False):
        widths.add(width)
        with guard:
            return inner(width, eager=eager)

    eng.device_step = guarded
    rng = np.random.default_rng(3)
    embeds = [rng.standard_normal((n_prefix, 128)).astype(np.float32)
              if n_prefix and i != 1 else None for i in range(3)]
    hs = [eng.submit(p, 4, prefix_embeds=e) for p, e in zip(prompts(), embeds)]
    eng.run()
    want = [plain.submit(p, 4, prefix_embeds=e) for p, e in zip(prompts(), embeds)]
    plain.run()
    assert [h.tokens for h in hs] == [h.tokens for h in want]
    assert widths == {1, 4} and guard.ops > 0


@pytest.mark.parametrize("impl", ["kernel", "fused_ref"])
def test_mamba_step_has_no_host_sync(impl, guard):
    """Reduced falcon-mamba-7b on the one-token step, every tick under the
    guard (a greedy and a seeded sampled request on three slots): the conv /
    ssm state update, masked by pos >= 0 and written in place, the f64
    fused multiply-adds of the CPU path and the read-out wait on nothing and make no tensor
    from host data; streams equal an unguarded run."""
    def mamba():
        return ServeEngine(EngineConfig(arch="falcon-mamba-7b", reduced=True, impl=impl,
                                        slots=3, capacity=32, device="cpu"))
    eng, plain = mamba(), mamba()
    warm_up(eng)
    inner, widths = eng.device_step, set()

    def guarded(width, eager=False):
        widths.add(width)
        with guard:
            return inner(width, eager=eager)

    eng.device_step = guarded
    samp = [None, S.SamplingParams(temperature=0.9, top_k=30, seed=2), None]
    hs = [eng.submit(p, 4, sampling=sp) for p, sp in zip(prompts(), samp)]
    eng.run()
    want = [plain.submit(p, 4, sampling=sp) for p, sp in zip(prompts(), samp)]
    plain.run()
    assert [h.tokens for h in hs] == [h.tokens for h in want]
    assert widths == {1} and guard.ops > 0


@pytest.mark.parametrize("impl", ["kernel", "fused_ref"])
def test_hybrid_step_has_no_host_sync(impl, guard):
    """Reduced recurrentgemma-9b on the one-token step, every tick under the
    guard (a greedy request whose 70-token prompt wraps the 64-slot ring,
    and a seeded sampled one, on three slots): the RG-LRU's masked state
    update, the ring insert at position % window and the ring's visible
    positions wait on nothing and make no tensor from host data; streams
    equal an unguarded run."""
    def hybrid():
        return ServeEngine(EngineConfig(arch="recurrentgemma-9b", reduced=True, impl=impl,
                                        slots=3, capacity=80, device="cpu"))
    eng, plain = hybrid(), hybrid()
    warm_up(eng)
    inner, widths = eng.device_step, set()

    def guarded(width, eager=False):
        widths.add(width)
        with guard:
            return inner(width, eager=eager)

    eng.device_step = guarded
    ps = [list(range(1, 71)), prompts()[1]]
    samp = [None, S.SamplingParams(temperature=0.9, top_k=30, seed=2)]
    hs = [eng.submit(p, 4, sampling=sp) for p, sp in zip(ps, samp)]
    eng.run()
    want = [plain.submit(p, 4, sampling=sp) for p, sp in zip(ps, samp)]
    plain.run()
    assert [h.tokens for h in hs] == [h.tokens for h in want]
    assert widths == {1} and guard.ops > 0


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "qwen2-7b", "recurrentgemma-9b"])
def test_recurrent_states_kept_puts_the_states_back(arch):
    """`steps.recurrent_states_kept` around a decode step and a write: a
    Mamba engine's conv / ssm states, and a hybrid's states and rings (the
    attn block's slot is written from the advanced states), come back byte
    for byte although the step changed them; an attention cache keeps what
    was written."""
    from repro_torch.launch.steps import recurrent_states_kept

    eng = ServeEngine(EngineConfig(arch=arch, reduced=True, impl="kernel", slots=3,
                                   capacity=32, device="cpu"))
    for p in prompts():
        eng.submit(p, 4)
    for _ in range(3):
        eng.step()
    before = cache_bytes(eng)
    with recurrent_states_kept(eng.cache, eng.cfg):
        run_step(eng._step, eng.params, eng.cache, eng.inputs, eng.samp, 1)
        stepped = cache_bytes(eng)
        tree_leaves(eng.cache)[0].view(torch.uint8).fill_(7)
    after = cache_bytes(eng)
    if arch != "qwen2-7b":
        assert not all(torch.equal(a, b) for a, b in zip(before, stepped))
        assert all(torch.equal(a, b) for a, b in zip(before, after))
    else:
        assert bool((after[0] == 7).all())


# ----------------------------------------------- idle run and static inputs
def cache_bytes(eng):
    return [t.view(torch.uint8).clone() for t in tree_leaves(eng.cache)]


@pytest.mark.parametrize("arch,kind", KINDS, ids=KIND_IDS)
def test_idle_step_leaves_every_cache_byte(arch, kind):
    """The capture's warm-up: a step at either width with every slot idle,
    after real ticks filled the cache (stale block tables kept), changes
    no cache byte."""
    eng = engine(arch, kind)
    for p in prompts():
        eng.submit(p, 3)
    for _ in range(4):
        eng.step()
    before = cache_bytes(eng)
    assert any(b.any() for b in before)
    for width in (1, eng.step_chunk):
        eng.inputs.set_idle()
        eng.device_step(width)
        assert all(torch.equal(a, b) for a, b in zip(before, cache_bytes(eng)))


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("arch,kind", KINDS, ids=KIND_IDS)
def test_step_inputs_are_static_and_prefill_ticks_run_the_full_chunk(arch, kind, chunk):
    """Every tick hands the step the same input tensors (views of one
    buffer); a tick that prefills runs [B, step_chunk] even when its widest
    chunk is shorter, a pure-decode tick [B, 1] (a one-token engine [B])."""
    eng = engine(arch, kind, chunk=chunk)
    step, seen = eng._step, []

    def spy(params, token, pos, cache, sampling, *, nvalid=None, block_tables=None):
        seen.append((tuple(token.shape), token.data_ptr(), pos.data_ptr(),
                     None if nvalid is None else nvalid.data_ptr(),
                     None if block_tables is None else block_tables.data_ptr(),
                     sampling["device"]["ngen"].data_ptr(), int(eng.inputs.host["nvalid"].max())))
        return step(params, token, pos, cache, sampling, nvalid=nvalid,
                    block_tables=block_tables)

    eng._step = spy
    for p in prompts():
        eng.submit(p, 4)
    eng.run()
    assert len({s[1:6] for s in seen}) == 1
    B = eng.slots
    if chunk == 1:
        assert {s[0] for s in seen} == {(B,)}
        return
    assert {s[0] for s in seen} == {(B, 1), (B, chunk)}
    for shape, *_, widest in seen:
        assert shape == ((B, chunk) if widest > 1 else (B, 1))
    assert any(1 < widest < chunk for *_, widest in seen)     # a short prefill tick


# -------------------------------------------------------- launch accounting
def test_capture_counts_are_added_per_replay():
    a, b = KernelCount("graph_test_a"), KernelCount("graph_test_b")
    a.launches, b.plain_on_cuda = 5, 1
    with recorded_counts() as moved:
        a.launches += 3                        # what a capture's wrappers add
    assert (a.launches, b.plain_on_cuda) == (5, 1)
    assert [(c.name, n, p) for c, n, p in moved] == [("graph_test_a", 3, 0)]
    for _ in range(2):
        add_counts(moved)
    assert (a.launches, a.plain_on_cuda, b.launches, b.plain_on_cuda) == (11, 0, 0, 1)


# ------------------------------------------------------------ sampling rows
def test_sampling_rows_live_on_the_device():
    """fill_slot / clear_slot write the host rows and the device rows;
    sample_tokens reads only the device rows (the host ``ngen`` is not
    consulted), and a given row tensor is used in place."""
    ngen = torch.full((3,), 7, dtype=torch.int32)
    batch = S.slot_batch(3, "cpu", rows={"ngen": ngen})
    assert batch["device"]["ngen"] is ngen and int(ngen.sum()) == 0
    S.fill_slot(batch, 1, S.SamplingParams(stop_token_ids=(4, 9)), max_tokens=3)
    dev = batch["device"]
    assert dev["stop_ids"][1, :3].tolist() == [4, 9, -1]
    assert int(dev["max_tokens"][1]) == 3 == batch["max_tokens"][1]
    logits = torch.zeros((3, 12))
    logits[:, 9] = 1.0
    tok, done = S.sample_tokens(logits, batch)
    assert tok.tolist() == [9, 9, 9] and done.tolist() == [False, True, False]
    batch["ngen"][0] = 10**6                    # host row only: no effect
    dev["ngen"][2] = np.iinfo(np.int32).max - 1
    assert S.sample_tokens(logits, batch)[1].tolist() == [False, True, True]
    S.clear_slot(batch, 1)
    assert dev["stop_ids"][1].tolist() == [-1] * S.MAX_STOP_IDS
    assert int(dev["max_tokens"][1]) == np.iinfo(np.int32).max


def test_softmax_scale_is_made_once():
    q = torch.randn((2, 4, 8)).to(torch.bfloat16)
    a, b = T._scale_factor(q, None), T._scale_factor(q.clone(), None)
    assert a.data_ptr() == b.data_ptr() and a.dim() == 0 and a.dtype == torch.bfloat16
    assert torch.equal(a, torch.tensor(np.float32(1 / np.sqrt(8)), dtype=torch.bfloat16))
    assert T._scale_factor(q.float(), 0.3).item() == np.float32(0.3)


def test_run_step_returns_tokens_and_done_rows():
    eng = engine("qwen2-7b", "paged_ams")
    eng.submit(prompts()[1], 2)
    eng.step()
    out = run_step(eng._step, eng.params, eng.cache, eng.inputs, eng.samp, 4)
    assert out.shape == (2, eng.slots) and out.dtype == torch.int32

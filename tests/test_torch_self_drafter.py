"""Port parity of the self drafters (`launch.speculative.SelfDrafter`,
``make_drafter("self" | "self-full")``): early-exit greedy proposals from
the serving model's first layer or whole stack through
`models.forward_seq`, against the JAX package's on the CPU with the same
numpy-made weights. Exact: proposals on the same histories, and
self-drafted speculative greedy streams equal to plain decoding's and to
the JAX speculative engine's, with the same proposal and accept counts.
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
from repro.launch import speculative as JSP  # noqa: E402
from repro.launch.config import EngineConfig as JEngineConfig  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.common import quantize_params as j_quantize_params  # noqa: E402
from repro_torch.cache import CacheConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.policy import QuantPolicy  # noqa: E402
from repro_torch.launch import speculative as SP  # noqa: E402
from repro_torch.launch.config import EngineConfig  # noqa: E402
from repro_torch.launch.engine import ServeEngine, prepare_params  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

SCHEME = "fp5.33-e2m3"
PAGE, CAP = 8, 48
SPEC_PROMPTS = [np.tile(np.arange(5, 11, dtype=np.int32), 3), np.arange(40, 53, dtype=np.int32),
                np.array([7, 3, 7, 3, 7, 3, 9], np.int32)]


@pytest.fixture(scope="module")
def weights():
    """Unquantized f32 params of the reduced qwen2-7b from the JAX package,
    and the same tree in numpy."""
    jp = j_init_params(jax.random.PRNGKey(0), get_config("qwen2-7b").reduced())
    return jp, jax.tree.map(np.asarray, jp)


def first_divergence(got, want):
    return [next((t for t, (a, b) in enumerate(zip(g, w)) if a != b), None)
            for g, w in zip(got, want)]


def serve(eng, prompts, max_tokens):
    hs = [eng.submit(p, max_tokens) for p in prompts]
    eng.run()
    return [list(h.tokens) for h in hs], eng.stats()


@pytest.mark.parametrize("name", ["self", "self-full"])
def test_self_drafter_proposals_match_reference(name, weights):
    """The port's SelfDrafter proposes what the JAX one proposes on the same
    histories, from the same FP5.33 weights (the reference engine's weight
    preparation on both sides)."""
    jp, npar = weights
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, jp)
    jpol = JQuantPolicy(scheme=SCHEME, impl="fused_ref", min_elements=1 << 10)
    tpol = QuantPolicy(scheme=SCHEME, impl="fused_ref", min_elements=1 << 10)
    jp, tp = j_quantize_params(jp, jpol), prepare_params(params_from_numpy(npar), tpol)
    cfg, tcfg = get_config("qwen2-7b").reduced(), t_get_config("qwen2-7b").reduced()
    jd = JSP.make_drafter(name, params=jp, cfg=cfg, capacity=32, policy=jpol)
    td = SP.make_drafter(name, params=tp, cfg=tcfg, capacity=32, policy=tpol)
    assert isinstance(td, SP.SelfDrafter) and td.draft_cfg.num_layers == (
        1 if name == "self" else tcfg.num_layers)
    rng = np.random.default_rng(1)
    for L, k in ((5, 3), (17, 4), (30, 2)):
        h = rng.integers(0, cfg.vocab_size, L).astype(np.int32)
        np.testing.assert_array_equal(td.propose(h, k), jd.propose(h, k))


@pytest.mark.parametrize("kind,chunk", [("paged_ams", 4), ("contiguous", 1)])
@pytest.mark.parametrize("drafter", ["self", "self-full"])
def test_self_speculative_greedy_equals_plain(drafter, kind, chunk, weights):
    """Speculative greedy streams with the self drafters (k = 2) equal plain
    decoding's and the JAX engine's, as the reference's
    test_greedy_equivalence_grid holds them; the self drafters propose every
    round, and the full stack's drafts land."""
    def engine(k=0):
        return ServeEngine(EngineConfig(
            arch="qwen2-7b", reduced=True, scheme=SCHEME, impl="kernel", slots=2,
            capacity=CAP, prefill_chunk=chunk, device="cpu", speculate_k=k, drafter=drafter,
            cache=CacheConfig(kind=kind, page_size=PAGE, impl="ref")),
            params=params_from_numpy(weights[1]))
    want, _ = serve(engine(), SPEC_PROMPTS, 8)
    eng = engine(2)
    assert isinstance(eng.drafter, SP.SelfDrafter)
    got, st = serve(eng, SPEC_PROMPTS, 8)
    assert got == want, first_divergence(got, want)
    assert st["spec_proposed"] > 0
    if drafter == "self-full":
        assert st["accept_rate"] > 0
    jeng = JServeEngine(JEngineConfig(
        arch="qwen2-7b", reduced=True, scheme=SCHEME, impl="fused_ref", slots=2, capacity=CAP,
        prefill_chunk=chunk, speculate_k=2, drafter=drafter,
        cache=JCacheConfig(kind=kind, page_size=PAGE)), params=weights[0])
    jgot, jst = serve(jeng, SPEC_PROMPTS, 8)
    assert jgot == got
    assert (jst["spec_proposed"], jst["spec_accepted"]) == (st["spec_proposed"],
                                                            st["spec_accepted"])

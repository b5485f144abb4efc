"""Port parity of the MoE FFN (`repro_torch.models.moe`) against the JAX
package's `repro.models.moe` on the CPU: reduced llama4-scout-17b-16e (4
experts, top-1, a shared expert of 256) and reduced dbrx-132b (4 experts,
top-2, no shared expert), with numpy-made inputs and weights carried
across by `params_from_numpy`.

The JAX side runs under `jax.jit`, as its engine runs it. Bit-equal: the
router's probabilities and combine weights from f32 and bf16 activations
(the f32 router product in the compiled dot's 4-lane order, XLA's exp
polynomial, the sums in expert order, the renormalisation), the
load-balance loss, and `moe_dense`'s output and loss with bf16
activations (the served case), on bf16 weights and on FP4.25 planes (the
port's kernel tier, the plain version of K1b here, against the
reference's Pallas call in interpret mode under its `vmap` over experts).
With f32 activations the experts' f32 products are summed in another
order than XLA's (its `vmap` merges the experts' gate and up products into
one [T, K] x [K, E * d_ff] dot, whose order the port does not copy): the
output is held to F32_TOL of its largest value (measured 3e-7), the loss
stays bit-equal. Ties in the top-k go to the lower expert index, as
`jax.lax.top_k` orders them. Summing only the routed
experts gives `moe_dense`'s bits (an unrouted expert's term is an exact
zero), which is what an expert-skipping step may rely on.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.policy import QuantPolicy as JQuantPolicy  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.common import quantize_params as j_quantize_params  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.policy import QuantPolicy  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.launch.engine import prepare_params  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCHS = ["llama4-scout-17b-16e", "dbrx-132b"]
T = 24                       # tokens: [B, S] = [4, 6]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
F32_TOL = 1e-6               # f32 activations: max |d| / max |y| of moe_dense


def bits(t):
    if isinstance(t, torch.Tensor):
        return t.detach().reshape(-1).contiguous().view(torch.uint8).numpy()
    return np.asarray(t).reshape(-1).view(np.uint8)


def to_t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def configs(arch):
    return get_config(arch).reduced(), t_get_config(arch).reduced()


def moe_params(arch, seed=0):
    """The MoE params of one block, as the engines serve them: numpy draws
    through the reference's `init_moe`, every leaf in bf16 (the router too:
    the reference's engine casts every leaf of ndim >= 2)."""
    cfg, _ = configs(arch)
    jp = JM.init_moe(jax.random.PRNGKey(seed), cfg)
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jp)


def activations(cfg, dtype, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, T // 4, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_gates_and_loss_match_reference(arch, dtype):
    """Probabilities, combine weights and the load-balance loss bit-equal
    to the jitted reference's, from f32 and bf16 activations; every row
    routes to experts_per_token experts whose weights sum to 1."""
    cfg, tcfg = configs(arch)
    npar = moe_params(arch)
    jd, td = DTYPES[dtype]
    x = activations(cfg, jd).reshape(T, cfg.d_model)
    jc, jpr = jax.jit(lambda p, x: JM._gates(p, x, cfg))(npar, x)
    jl = jax.jit(lambda c, p: JM.load_balance_loss(c, p, cfg.num_experts))(jc, jpr)
    tp = params_from_numpy(npar)
    tc, tpr = TM.gates(tp, to_t(x), tcfg)
    tl = TM.load_balance_loss(tc, tpr, tcfg.num_experts)
    np.testing.assert_array_equal(bits(tpr), bits(jpr))
    np.testing.assert_array_equal(bits(tc), bits(jc))
    np.testing.assert_array_equal(bits(tl), bits(jl))
    assert ((tc > 0).sum(-1) == cfg.experts_per_token).all()
    np.testing.assert_allclose(tc.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_top_k_ties_go_to_the_lower_index(arch):
    """Experts 1 and 2 share their router column, so every row's two
    logits tie: the lower index wins (and, at top-2, ranks first), as in
    the reference. `top_k` keeps index order among equal values."""
    cfg, tcfg = configs(arch)
    npar = moe_params(arch)
    w = np.asarray(npar["router"]["w"], np.float32)
    w[:, 1] += 0.5           # experts 1 and 2 lead every row (x > 0 below)
    w[:, 2] = w[:, 1]
    npar["router"]["w"] = np.asarray(jnp.asarray(w).astype(jnp.bfloat16))
    x = jnp.abs(activations(cfg, jnp.float32).reshape(T, cfg.d_model))
    jc, _ = jax.jit(lambda p, x: JM._gates(p, x, cfg))(npar, x)
    tc, tpr = TM.gates(params_from_numpy(npar), to_t(x), tcfg)
    assert (tpr[:, 1] == tpr[:, 2]).all() and (tpr[:, 1] == tpr.max(-1).values).all()
    np.testing.assert_array_equal(bits(tc), bits(jc))
    _, idx = TM.top_k(tpr, cfg.experts_per_token)
    assert (idx[:, 0] == 1).all()
    if cfg.experts_per_token > 1:
        assert (idx[:, 1] == 2).all()
    else:
        assert (tc[:, 1] == 1).all() and (tc[:, 2] == 0).all()
    ties = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3]])
    v, i = TM.top_k(ties, 3)
    assert i.tolist() == [[0, 1, 2], [1, 2, 3]] and (v[1] == ties[1, 1]).all()


@pytest.mark.parametrize("weights", ["bf16", "fp4.25-kernel"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_reference(arch, dtype, weights):
    """`moe_dense` against the jitted reference's, on bf16 weights
    (torch.matmul / XLA's dot) and FP4.25 planes (the port's kernel tier
    against ``pallas_interpret``): output and loss bit-equal from bf16
    activations; from f32 ones the loss bit-equal and the output within
    F32_TOL of its largest value."""
    cfg, tcfg = configs(arch)
    npar = moe_params(arch)
    jd, td = DTYPES[dtype]
    x = activations(cfg, jd)
    if weights == "bf16":
        jp, jpol, tp, tpol = npar, None, params_from_numpy(npar), None
    else:
        jp, jpol = None, JQuantPolicy(scheme="fp4.25-e2m2", impl="pallas_interpret",
                                      min_elements=1 << 10)
        tpol = QuantPolicy(scheme="fp4.25-e2m2", impl="kernel", min_elements=1 << 10)
        jp = j_quantize_params(jax.tree.map(jnp.asarray, npar), jpol)
        tp = prepare_params(params_from_numpy(npar), tpol)
        for name in ("w_gate", "w_up", "w_down"):
            assert "hi" in tp["experts"][name] and tp["experts"][name]["hi"].shape[0] == 4
        assert "w" in tp["router"]
    jy, jaux = jax.jit(lambda p, x: JM.moe_dense(p, x, cfg, jpol))(jp, x)
    ty, taux = TM.moe_dense(tp, to_t(x), tcfg, tpol)
    assert ty.dtype == td and ty.shape == x.shape
    if dtype == "bf16":
        np.testing.assert_array_equal(bits(ty), bits(jy))
    else:
        jy = np.asarray(jy)
        assert np.abs(ty.numpy() - jy).max() <= F32_TOL * np.abs(jy).max()
    np.testing.assert_array_equal(bits(taux), bits(jaux))


@pytest.mark.parametrize("impl", ["ref", "fused_ref"])
@pytest.mark.parametrize("arch", ARCHS)
def test_routed_experts_alone_give_the_dense_bits(arch, impl):
    """Summing only each token's routed experts (their bf16 outputs times
    the bf16 combine weights, in f32, rounded once to bf16, then the
    shared expert) gives `moe_dense`'s bits on bf16 activations through the
    port's plain path, FP4.25 weights: the dense combine's unrouted terms
    are exact zeros. The routed experts see only their own tokens."""
    cfg, tcfg = configs(arch)
    tpol = QuantPolicy(scheme="fp4.25-e2m2", impl=impl, min_elements=1 << 10)
    tp = prepare_params(params_from_numpy(moe_params(arch)), tpol)
    x = to_t(activations(cfg, jnp.bfloat16))
    want, _ = TM.moe_dense(tp, x, tcfg, tpol)
    xf = x.reshape(T, -1)
    combine, _ = TM.gates(tp, xf, tcfg)
    acc = torch.zeros(xf.shape, dtype=torch.float32)
    for e in range(tcfg.num_experts):
        rows = torch.nonzero(combine[:, e] > 0).flatten()
        if rows.numel():
            ye = TM.expert_ffn(tree_map(lambda t: t[e], tp["experts"]), xf[rows],
                               tcfg.ffn_activation, tpol)
            acc[rows] += combine[rows, e:e + 1].to(torch.bfloat16).float() * ye.float()
    got = acc.to(torch.bfloat16)
    if "shared" in tp:
        got = got + TM.expert_ffn(tp["shared"], xf, tcfg.ffn_activation, tpol)
    np.testing.assert_array_equal(bits(got.reshape(x.shape)), bits(want))


def test_moe_apply_refuses_more_than_one_device():
    _, tcfg = configs("llama4-scout-17b-16e")
    tp = params_from_numpy(moe_params("llama4-scout-17b-16e"))
    x = torch.zeros((1, 1, tcfg.d_model), dtype=torch.bfloat16)
    y, _ = TM.moe_apply(tp, x, tcfg)
    assert y.shape == x.shape
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Modules to port"):
        TM.moe_apply(tp, x, tcfg, devices=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_layout(arch):
    """The port's own draws: experts stacked [E, ...] in the reference's
    tree, the router [D, E] f32 whatever the dtype, the shared expert where
    the config has one; ``expert_fn`` sees each expert before stacking."""
    _, tcfg = configs(arch)
    seen = []
    p = TM.init_moe(torch.Generator().manual_seed(0), tcfg, dtype=torch.bfloat16,
                    expert_fn=lambda ep: seen.append(ep) or ep)
    jp = JM.init_moe(jax.random.PRNGKey(0), configs(arch)[0])
    assert jax.tree.structure(jax.tree.map(lambda a: 0, jp)) == jax.tree.structure(
        jax.tree.map(lambda a: 0, tree_map(lambda t: 0, p)))
    assert len(seen) == tcfg.num_experts
    assert p["router"]["w"].dtype == torch.float32
    assert p["experts"]["w_gate"]["w"].shape == (tcfg.num_experts, tcfg.d_model, tcfg.d_ff)
    assert ("shared" in p) == bool(tcfg.moe_shared_expert_ff)

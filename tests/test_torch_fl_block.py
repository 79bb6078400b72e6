"""The port's fused PsiFormer-layer forward Laplacian against the JAX package.

``psiformer_block_fl_plain`` (the CPU path of
``deepqmc_tpu_torch.ops.psiformer_block_fl``) is held to the JAX whole-block
Pallas kernel ``block_fl_call`` in interpret mode on the block of
``tests/test_fl_block.py`` (relative 1e-10 at float64: the same algebra summed
in another order) and to the port's own per-op path at the small PsiFormer
widths (relative 1e-12: the same rules in the same order).  The small H2O
PsiFormer built with ``block_kernel=True`` is held to JAX's forward Laplacian
with its block rule on (interpret mode) at relative 1e-9, the tolerance of
``test_torch_hamil.py`` and for the same reason.  All inputs come from numpy
with a seed.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fl_block import DM, HEADS, KDIR, N_TOK, _block, _h_of_factory, _params
from torch_parity import SMALL, jax_model, jax_phys_conf, torch_model, torch_phys_conf, walkers

import deepqmc_tpu_torch as dqt
from deepqmc_tpu.ops import fl_block as jax_fl_block
from deepqmc_tpu_torch import ablate_fl_block, fwdlap
from deepqmc_tpu_torch.gnn.update_features import NodeAttentionElectronUpdateFeature
from deepqmc_tpu_torch.ops import _cuda, fl_attention, fl_block

RTOL_JAX_KERNEL = 1e-10
RTOL_PER_OP = 1e-12
RTOL_SLICE = 1e-9


def _triple_of_test_fl_block():
    """The FL triple of tests/test_fl_block.py: h(x), its Jacobian and Laplacian."""
    h_of = _h_of_factory()
    x = jnp.asarray(np.random.default_rng(2).normal(size=(KDIR,)))
    jac = jnp.moveaxis(jax.jacfwd(h_of)(x), -1, 0)
    hess = jax.hessian(lambda xv: h_of(xv).reshape(-1))(x)
    lap = jnp.trace(hess, axis1=-2, axis2=-1).reshape(N_TOK, DM)
    return np.array(h_of(x))[None], np.array(jac)[None], np.array(lap)[None]


def _random_triple(seed, B, K, n, d):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, n, d)), rng.normal(size=(B, K, n, d)), rng.normal(size=(B, n, d))


@pytest.mark.parametrize('triple', ['test_fl_block', 'random'])
def test_plain_matches_interpret_mode_block_kernel(triple):
    params = _params()
    if triple == 'random':
        x, jac, lap = _random_triple(3, 3, KDIR, N_TOK, DM)
    else:
        x, jac, lap = _triple_of_test_fl_block()
    closed = jax.make_jaxpr(_block)(jnp.asarray(x[0]), *params)
    want = jax_fl_block.block_fl_call(
        closed, KDIR, 0, *map(jnp.asarray, (x, jac, lap)), list(params), interpret=True
    )
    got = fl_block.psiformer_block_fl_plain(
        *(torch.as_tensor(t) for t in (x, jac, lap)),
        *(torch.as_tensor(np.array(p)) for p in params), HEADS,
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL_JAX_KERNEL,
                                   atol=RTOL_JAX_KERNEL)


def _layer(d, heads, seed, block_kernel=False):
    gen = torch.Generator().manual_seed(seed)
    return NodeAttentionElectronUpdateFeature.psiformer(
        d, num_heads=heads, gen=gen, block_kernel=block_kernel
    ).double()


@pytest.mark.parametrize('seed', [0, 1])
def test_plain_matches_per_op_path(seed):
    """The plain block against the port's per-op rules on one layer at the small
    PsiFormer widths (embedding 32, 2 heads; H2O: n = 10, K = 30)."""
    d, heads = SMALL['embedding_dim'], SMALL['num_heads']
    layer = _layer(d, heads, seed)
    x, jac, lap = (torch.as_tensor(t) for t in _random_triple(seed, 3, 30, 10, d))
    with torch.inference_mode():
        want = layer(fwdlap.FL(x, jac, lap))
        got = fl_block.psiformer_block_fl_plain(x, jac, lap, *layer.block_weights(), heads)
    for g, w in zip(got, (want.x, want.jac, want.lap)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL_PER_OP, atol=RTOL_PER_OP)


def test_layer_switch_routes_fl_triples_only():
    """With ``block_kernel`` an FL triple goes through the block wrapper (the plain
    version on the CPU, no launch); a plain tensor takes the per-op forward."""
    d, heads = SMALL['embedding_dim'], SMALL['num_heads']
    fused, per_op = _layer(d, heads, 2, block_kernel=True), _layer(d, heads, 2)
    x, jac, lap = (torch.as_tensor(t) for t in _random_triple(4, 2, 6, 10, d))
    before = fl_block.psiformer_block_fl.launches
    with torch.inference_mode():
        got, want = fused(fwdlap.FL(x, jac, lap)), per_op(fwdlap.FL(x, jac, lap))
        assert torch.equal(fused(x), per_op(x))
    assert fl_block.psiformer_block_fl.launches == before == 0
    for g, w in zip((got.x, got.jac, got.lap), (want.x, want.jac, want.lap)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL_PER_OP, atol=RTOL_PER_OP)


@pytest.mark.parametrize('n, on_card, want', [
    (10, True, True), (32, True, True), (33, True, False), (42, True, False),
    (42, False, True), (64, False, True),
])
def test_block_path_takes_by_size(n, on_card, want):
    """On the card the block path takes a layer up to MAX_N = 32 electrons, the
    kernel's shared-memory limit; on the CPU always (the plain version)."""
    x = SimpleNamespace(is_cuda=True, shape=(2, n, 32)) if on_card else torch.zeros(2, n, 32)
    assert fl_block.takes(x) is want


@pytest.mark.parametrize('n', [10, 33, 42])
def test_layer_dispatch_past_32_electrons_on_the_card(n, monkeypatch):
    """With tensors seen as on the card, a layer with ``block_kernel=True``
    launches the block kernel up to 32 electrons and takes the per-op rules
    (one attention core, no block launch) at n = 33 and 42, with the per-op
    layer's result bit for bit."""
    takes = fl_block.takes
    monkeypatch.setattr(fl_block, 'takes',
                        lambda x: takes(SimpleNamespace(is_cuda=True, shape=x.shape)))
    blocks = _counted(monkeypatch, fl_block, 'psiformer_block_fl')
    attention = _counted(monkeypatch, fl_attention, 'mha_core_fl')
    d, heads = 16, 2
    fused, per_op = _layer(d, heads, 6, block_kernel=True), _layer(d, heads, 6)
    h = fwdlap.FL(*(torch.as_tensor(t) for t in _random_triple(7, 2, 3, n, d)))
    with torch.inference_mode():
        got = fused(h)
        assert (len(blocks), len(attention)) == ((1, 0) if n <= fl_block.MAX_N else (0, 1))
        want = per_op(h)
    if n > fl_block.MAX_N:
        for g, w in zip((got.x, got.jac, got.lap), (want.x, want.jac, want.lap)):
            assert torch.equal(g, w)


def test_layer_on_cpu_takes_the_block_path_at_any_size(monkeypatch):
    """On the CPU the layer with ``block_kernel=True`` runs the block wrapper
    (its plain version) at n = 42 too, as before the dispatch by size."""
    launches = fl_block.psiformer_block_fl.launches
    blocks = _counted(monkeypatch, fl_block, 'psiformer_block_fl')
    d, heads = 16, 2
    fused = _layer(d, heads, 8, block_kernel=True)
    x, jac, lap = (torch.as_tensor(t) for t in _random_triple(9, 2, 3, 42, d))
    with torch.inference_mode():
        got = fused(fwdlap.FL(x, jac, lap))
    assert blocks == ['psiformer_block_fl']
    monkeypatch.undo()
    assert fl_block.psiformer_block_fl.launches == launches
    want = fl_block.psiformer_block_fl_plain(x, jac, lap, *fused.block_weights(), heads)
    for g, w in zip((got.x, got.jac, got.lap), want):
        assert torch.equal(g, w)


def test_wrapper_takes_plain_version_on_cpu():
    layer = _layer(16, 2, 3)
    args = [torch.as_tensor(t) for t in _random_triple(5, 2, 7, 5, 16)]
    args += [w.detach() for w in layer.block_weights()]
    got = fl_block.psiformer_block_fl(*args, 2)
    want = fl_block.psiformer_block_fl_plain(*args, 2)
    assert fl_block.psiformer_block_fl.launches == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _counted(monkeypatch, module, name):
    calls = []
    inner = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(name)
        return inner(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return calls


def test_slice_matches_jax_block_rule(monkeypatch):
    """The small H2O PsiFormer with ``block_kernel=True`` against JAX's forward
    Laplacian with the block rule on (Pallas interpret mode): log-psi gradient,
    Laplacian and E_loc on the same parameters and walkers."""
    from deepqmc_tpu.fwdlap import forward_laplacian as jax_forward_laplacian

    monkeypatch.setenv('DEEPQMC_TPU_BLOCK_KERNEL_INTERPRET', '1')
    jax_calls = _counted(monkeypatch, jax_fl_block, 'block_fl_call')
    hamil_j, ansatz, params = jax_model('H2O', seed=2)
    r = walkers(hamil_j, 'init_sample', n=2, seed=4)

    # functions made after the switch is set, so that no earlier trace is reused
    def lap_grad(params, pc):
        f = lambda x: ansatz.apply(params, pc.replace(r=x.reshape(-1, 3))).log
        return jax_forward_laplacian(f)(pc.r.flatten())

    pc_j = jax_phys_conf(hamil_j, r)
    lap_j, grad_j = jax.jit(jax.vmap(lap_grad, (None, 0)))(params, pc_j)
    eloc_j, _ = jax.jit(jax.vmap(hamil_j.local_energy(ansatz.apply), (None, None, 0)))(
        None, params, pc_j
    )
    # the rule ran for every layer of both traces (custom_vmap may trace it twice)
    assert len(jax_calls) >= 2 * SMALL['n_interactions']

    block_calls = _counted(monkeypatch, fl_block, 'psiformer_block_fl')
    attention_calls = _counted(monkeypatch, fl_attention, 'mha_core_fl')
    hamil_t, wf = torch_model('H2O', params, block_kernel=True)
    pc_t = torch_phys_conf(hamil_t, r)
    with torch.inference_mode():
        lap_t, grad_t = fwdlap.forward_laplacian(lambda x: wf(pc_t.replace(r=x)).log)(pc_t.r)
        eloc_t, _ = hamil_t.local_energy(wf, pc_t)
    assert len(block_calls) == 2 * SMALL['n_interactions'] and not attention_calls

    for name, g, w in (('grad', grad_t, grad_j), ('lap', lap_t, lap_j), ('E_loc', eloc_t, eloc_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL_SLICE, err_msg=name)


def test_block_path_operands_pass_the_kernel_checks(monkeypatch):
    """A float32 evaluation on the CPU of the full-width PsiFormer with
    ``block_kernel=True``, through a wrapper that runs the kernel's input checks
    before its plain version: the block path hands the kernel operands it takes,
    once per layer per local energy, and never reaches the attention kernel."""
    seen = []

    def block(*args):
        fl_block.validate(*args)
        seen.append('fl_block')
        return fl_block.psiformer_block_fl_plain(*args)

    monkeypatch.setattr(fl_block, 'psiformer_block_fl', block)
    attention_calls = _counted(monkeypatch, fl_attention, 'mha_core_fl')
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2O'))
    wf = dqt.psiformer_ansatz(hamil, block_kernel=True)  # the preset's full widths
    out = list(dqt.evaluate(hamil, wf, n_walkers=4, steps=2, decorr=1, device='cpu'))
    assert seen == ['fl_block'] * 4 * 2 and not attention_calls
    for _, _, E_loc, _ in out:
        assert E_loc.dtype == torch.float32 and torch.isfinite(E_loc).all()


def _kernel_args(n=10, d=32, heads=2, K=6, B=2):
    layer = _layer(d, heads, 5).float()
    x, jac, lap = (torch.as_tensor(t, dtype=torch.float32)
                   for t in _random_triple(6, B, K, n, d))
    return [x, jac, lap, *(w.detach() for w in layer.block_weights())], heads


@pytest.mark.parametrize(
    'fault', ['tokens', 'head_width', 'heads', 'dtype', 'shape', 'bias', 'layout', 'alignment']
)
def test_kernel_input_checks_reject(fault):
    args, heads = _kernel_args()
    fl_block.validate(*args, heads)
    if fault == 'tokens':  # n > 32
        args, heads = _kernel_args(n=33)
    elif fault == 'head_width':  # dh = 6 is not a multiple of 4 (float4 rows)
        args, heads = _kernel_args(d=12, heads=2)
    elif fault == 'heads':  # H * dh != d
        heads = 3
    elif fault == 'dtype':
        args[1] = args[1].double()
    elif fault == 'shape':
        args[2] = args[2][:, :-1]
    elif fault == 'bias':
        args[8] = args[8][:-4]
    elif fault == 'layout':
        args[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    else:
        w = args[6]
        shifted = torch.empty(w.numel() + 1, dtype=w.dtype)[1:].view_as(w)
        args[6] = shifted.copy_(w)
    with pytest.raises((TypeError, ValueError)):
        fl_block.validate(*args, heads)


def _tf32(x):
    """Round float32 to TF32 (10-bit mantissa), to nearest with ties away: add half
    a TF32 unit to the bits and clear the low 13 (what the kernel's tensor cores
    read of an operand it has added half a unit to)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(terms):
    """``a @ w`` as the kernel's tensor cores form it: one TF32 product, or the
    split-TF32 sum lo*hi + hi*lo + hi*hi with x = hi + lo, in float32."""

    def matmul(a, w):
        ah, wh = _tf32(a), _tf32(w)
        if terms == 1:
            return ah @ wh
        al, wl = _tf32(a - ah), _tf32(w - wh)
        return al @ wh + ah @ wl + ah @ wh

    return matmul


@pytest.mark.parametrize('terms', [1, 3])
def test_split_tf32_products_hold_the_kernel_tolerance(terms, monkeypatch):
    """The fused kernel runs the layer's six d x d products on TF32 tensor cores.
    Emulated in the plain version at the H2O layer's widths (d = 256, 4 heads,
    n = 10, K = 30; the preset's initialisation), the three-term split product
    keeps (y, J_y, L_y) within chip_smoke.KERNEL_RTOL of the float64 plain
    version, and a single TF32 product does not: the split is what lets the
    kernel keep the float32 kernels' tolerance."""
    import chip_smoke

    layer = _layer(256, 4, 0)
    weights = [w.detach() for w in layer.block_weights()]
    triple = _random_triple(7, 4, 30, 10, 256)
    with torch.inference_mode():
        ref = fl_block.psiformer_block_fl_plain(*map(torch.as_tensor, triple), *weights, 4)
        mm = _tf32_matmul(terms)
        monkeypatch.setattr(fwdlap.FL, '__matmul__',
                            lambda h, w: fwdlap.FL(mm(h.x, w), mm(h.jac, w), mm(h.lap, w)))
        got = fl_block.psiformer_block_fl_plain(
            *(torch.as_tensor(t, dtype=torch.float32) for t in triple),
            *(w.float() for w in weights), 4,
        )
    rel = [chip_smoke.max_errors(g.double(), r)[1] for g, r in zip(got, ref)]
    if terms == 3:
        assert max(rel) <= chip_smoke.KERNEL_RTOL, rel
    else:
        assert max(rel) > chip_smoke.KERNEL_RTOL, rel


@pytest.mark.parametrize('variant', sorted(ablate_fl_block.VARIANTS))
def test_ablation_variants_edit_the_kernel_source(variant):
    """Each variant of ``python -m deepqmc_tpu_torch.ablate_fl_block`` finds every
    source fragment it edits in ``csrc/fl_block.cu`` and keeps the braces
    balanced, so an edit of the kernel that moves a fragment fails here and not
    first on the card."""
    src = (_cuda.CSRC / 'fl_block.cu').read_text()
    edits = ablate_fl_block.VARIANTS[variant]
    edited = ablate_fl_block._edit(src, edits)
    assert (edited != src) == bool(edits)
    assert edited.count('{') - edited.count('}') == src.count('{') - src.count('}')

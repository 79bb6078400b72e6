"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Builds the small PsiFormer (2 determinants, embedding 32, 2 layers, 2 heads,
as ``__graft_entry__._flagship(small=True)``) in both packages with the same
parameters: JAX's ``init`` perturbed by seeded numpy noise (so the envelope
and cusp parameters are not all ones), converted with
``deepqmc_tpu_torch.convert``.  Walkers come from the JAX ``init_sample`` or,
for LiH, from the pinned self-golden walker.

Besides the named closed-shell molecules, two open-shell systems are built
from their geometry in both packages (no molecule data is added to either):
the Li atom (2 up, 1 down) and triplet H2 (2 up, 0 down).
"""

import functools
from pathlib import Path

import jax
import numpy as np
import torch

# The suite runs one pytest worker per core (xdist): each worker's CPU
# tensors take one thread, as intra-op threads over every core in every
# worker oversubscribe the machine and slow the port's tests by about a third
torch.set_num_threads(1)


def jit_once(fun, **kwargs):
    """``jax.jit`` of a JAX reference that runs once (an init, psi or E_loc of
    a few walkers): compiled at XLA's optimisation level 0, which takes about
    0.6 of the compile time at these sizes, where LLVM's passes dominate."""
    return jax.jit(fun, compiler_options={'xla_backend_optimization_level': 0}, **kwargs)


SMALL = {'n_determinants': 2, 'embedding_dim': 32, 'n_interactions': 2, 'num_heads': 2}
# the small FermiNet and default presets (tests/test_wf.py's, embedding 16)
SMALL_ZOO = {'n_determinants': 2, 'embedding_dim': 16, 'n_interactions': 2,
             'two_particle_stream_dim': 8}


def small_kwargs(preset: str, **overrides) -> dict:
    return {**(SMALL if preset == 'psiformer' else SMALL_ZOO), **overrides}
SELFGOLDENS = Path(__file__).parent / 'test_reference_parity' / 'selfgoldens.npz'


OPEN_SHELL = {
    'Li': dict(coords=[[0.0, 0.0, 0.0]], charges=[3], charge=0, spin=1),
    'H2_triplet': dict(coords=[[0.0, 0.0, 0.0], [0.742, 0.0, 0.0]], charges=[1, 1],
                       charge=0, spin=2, unit='angstrom'),
}


def molecule(package, mol_name: str):
    """``package.Molecule`` by name, or built from ``OPEN_SHELL``."""
    if mol_name in OPEN_SHELL:
        return package.Molecule(**OPEN_SHELL[mol_name])
    return package.Molecule.from_name(mol_name)


def jax_model(mol_name: str, seed: int = 0, preset: str = 'psiformer', **overrides):
    """(JAX hamiltonian, ansatz, perturbed params as numpy) of the small
    ``preset`` with the keyword ``overrides``."""
    import deepqmc_tpu as dqj
    from deepqmc_tpu.presets import ansatz_preset
    from deepqmc_tpu.wf import instantiate_ansatz

    hamil = dqj.MolecularHamiltonian(mol=molecule(dqj, mol_name))
    ansatz = instantiate_ansatz(hamil, ansatz_preset(preset, **small_kwargs(preset, **overrides)))
    pc = init_sample(hamil, 1, seed)[0]
    params = jit_once(ansatz.init)(jax.random.PRNGKey(seed + 1), pc)
    rng = np.random.default_rng(seed)
    params = {
        path: {k: np.asarray(v) + 0.1 * rng.normal(size=np.shape(v)) for k, v in bundle.items()}
        for path, bundle in params.items()
    }
    return hamil, ansatz, params


def torch_model(mol_name: str, params, block_kernel: bool = False, preset: str = 'psiformer',
                overrides=None, **hamil_kwargs):
    """(port hamiltonian, wave function in float64 holding ``params``) of the
    small ``preset`` with the keyword ``overrides``."""
    import deepqmc_tpu_torch as dqt
    from deepqmc_tpu_torch.convert import state_dict_from_jax

    hamil = dqt.MolecularHamiltonian(mol=molecule(dqt, mol_name), **hamil_kwargs)
    kwargs = small_kwargs(preset, **(overrides or {}))
    if preset == 'psiformer':
        kwargs['block_kernel'] = block_kernel
    wf = dqt.ansatz_preset(preset, **kwargs)(hamil).to(torch.float64)
    wf.load_state_dict(state_dict_from_jax(params, wf))
    return hamil, wf


_SAMPLES: dict = {}


def init_sample(hamil_jax, n: int, seed: int):
    """``hamil_jax.init_sample(PRNGKey(seed), its coordinates, n)``, drawn once
    per process for each molecule, electron split, valence and ``n``, ``seed``
    (an eager JAX program of many small operations, about a second a call)."""
    mol = hamil_jax.mol
    key = (np.asarray(mol.coords).tobytes(), np.asarray(mol.charges).tobytes(), mol.charge,
           mol.spin, hamil_jax.n_up, hamil_jax.n_down,
           np.asarray(hamil_jax.ns_valence).tobytes(), n, seed)
    if key not in _SAMPLES:
        _SAMPLES[key] = hamil_jax.init_sample(jax.random.PRNGKey(seed), mol.coords, n)
    return _SAMPLES[key]


def walkers(hamil_jax, source: str, n: int = 3, seed: int = 0) -> np.ndarray:
    """Electron positions [n, n_elec, 3] from ``init_sample`` or the self-goldens."""
    if source == 'init_sample':
        return np.asarray(init_sample(hamil_jax, n, seed).r)
    # the pinned LiH walker: edges_ne[I, i] = r_i - R_I
    edges_ne = np.load(SELFGOLDENS)['edges_ne']
    r = edges_ne[0] + np.asarray(hamil_jax.mol.coords)[0]
    return r[None]


def jax_phys_conf(hamil_jax, r: np.ndarray):
    import jax.numpy as jnp

    from deepqmc_tpu.types import PhysicalConfiguration

    n = len(r)
    R = jnp.tile(jnp.asarray(hamil_jax.mol.coords)[None], (n, 1, 1))
    return PhysicalConfiguration(R, jnp.asarray(r), jnp.zeros(n, dtype=jnp.int32))


def torch_phys_conf(hamil_torch, r: np.ndarray):
    from deepqmc_tpu_torch.types import PhysicalConfiguration

    R = torch.as_tensor(hamil_torch.mol.coords, dtype=torch.float64)
    return PhysicalConfiguration(R, torch.tensor(r), torch.zeros(len(r), dtype=torch.long))


def jax_batch(hamil_jax, r: np.ndarray):
    """(phys_conf, weight, data) of one molecule and one state, batch shape
    [1, 1, B], as the JAX loss and optimizers take it; unit weights."""
    import jax.numpy as jnp

    pc = jax.tree_util.tree_map(lambda x: x[None, None], jax_phys_conf(hamil_jax, r))
    return pc, jnp.ones((1, 1, len(r))), {}


def assert_close(got, want, rel: float, what: str = ''):
    """max |got - want| <= rel * max |want| (a tensor or array of any shape)."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(initial=0.0), np.abs(want).max(initial=0.0)
    assert err <= rel * scale, f'{what}: max err {err:.3e} > {rel:.0e} x {scale:.3e}'


def grads_by_jax_path(grads: dict, wf) -> dict:
    """The port's ``{state_dict key: tensor}`` as ``{(JAX path, name): tensor}``."""
    from deepqmc_tpu_torch.nn import jax_param_paths

    paths = jax_param_paths(wf)
    return {paths[k]: v for k, v in grads.items()}


def feed_draws(monkeypatch, normals, uniforms):
    """Both packages' samplers draw ``normals`` and ``uniforms`` in turn (each
    list cycles): the JAX package through ``jax.random.normal`` and
    ``uniform``, the port through its sampler helpers ``normal`` and ``uniform``."""
    import jax.numpy as jnp

    from deepqmc_tpu_torch.sampling import electron_samplers

    taken = {}

    def take(kind, values):
        i = taken.get(kind, 0)
        taken[kind] = i + 1
        return values[i % len(values)]

    monkeypatch.setattr(jax.random, 'normal',
                        lambda key, shape, dtype=None: jnp.asarray(take('jn', normals)))
    monkeypatch.setattr(jax.random, 'uniform',
                        lambda key, shape=(), *a, **k: jnp.asarray(take('ju', uniforms)))
    monkeypatch.setattr(electron_samplers, 'normal',
                        lambda gen, like: torch.tensor(take('tn', normals)))
    monkeypatch.setattr(electron_samplers, 'uniform',
                        lambda gen, n, like: torch.tensor(take('tu', uniforms)))


def assert_sampler_states(got, want, keys, rel=1e-12):
    """Ages and signs equal; the entries ``keys`` (``psi`` by its log) to ``rel``."""
    np.testing.assert_array_equal(got['age'].numpy(), np.asarray(want['age']))
    np.testing.assert_array_equal(got['psi'].sign.numpy(), np.asarray(want['psi'].sign))
    for key in keys:
        g = got[key].log if key == 'psi' else got[key]
        w = want[key].log if key == 'psi' else want[key]
        assert_close(g, w, rel, key)


def assert_stats(got, want, rel=1e-12):
    """The same stats keys, each value to ``rel`` (absolute 1e-14 near 0)."""
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(value), rtol=rel,
                                   atol=1e-14, err_msg=key)


@functools.cache
def models(mol_name: str, seed: int = 0):
    """(JAX hamiltonian, ansatz, params; port hamiltonian, wave function;
    16 walkers from ``init_sample``), built once per process: callers must
    not change them."""
    hamil_j, ansatz, params = jax_model(mol_name, seed=seed)
    hamil_t, wf = torch_model(mol_name, params)
    return hamil_j, ansatz, params, hamil_t, wf, walkers(hamil_j, 'init_sample', n=16, seed=seed)

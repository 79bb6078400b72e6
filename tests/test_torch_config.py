"""The port's configuration layer against the JAX package's.

Every dict of ``deepqmc_tpu_torch/conf`` against its YAML file in
``deepqmc_tpu/conf`` (targets renamed by ``config.port_target``), and no
option beside them; ``compose`` against JAX's ``compose`` for the override
lists of ``tests/test_config.py``, ``tests/test_app.py`` and more, as equal
trees; the override-value parser against ``yaml.safe_load`` (hypothesis
over ints, floats, booleans and nulls in YAML 1.1's forms, quoted and plain
strings and flow lists); instantiation, resolvers and target aliases;
``Molecule.from_file`` and ``read_molecule_dataset`` on all 28 packaged
geometries and a block-list file; ``validate_kwargs``.
"""

import logging
import math
from pathlib import Path

import numpy as np
import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

import deepqmc_tpu as dqj
import deepqmc_tpu_torch as dqt
from deepqmc_tpu import config as jax_config
from deepqmc_tpu.validate_kwargs import validate_kwargs as jax_validate_kwargs
from deepqmc_tpu_torch import conf, config
from deepqmc_tpu_torch.molecule import read_molecule_dataset, read_molecule_file
from deepqmc_tpu_torch.validate_kwargs import validate_kwargs

JAX_CONF = Path(dqj.__file__).parent / 'conf'
YAML_FILES = sorted(JAX_CONF.rglob('*.yaml'))
MOL_FILES = sorted(f for f in (JAX_CONF / 'hamil' / 'mol').glob('*.yaml')
                   if f.stem != 'from_file')


def renamed(node):
    """A JAX config tree with each target renamed onto the port."""
    if isinstance(node, dict):
        return {k: config.port_target(v) if k == '_target_' else renamed(v)
                for k, v in node.items()}
    if isinstance(node, list):
        return [renamed(v) for v in node]
    return node


def _port_dict(path: Path):
    rel = path.relative_to(JAX_CONF).with_suffix('')
    if rel.parent == Path('.'):
        return conf.ROOTS[rel.name]
    return conf.GROUPS[str(rel.parent)][rel.name]


@pytest.mark.parametrize('path', YAML_FILES, ids=lambda p: str(p.relative_to(JAX_CONF)))
def test_conf_dict_equals_its_yaml_file(path):
    assert _port_dict(path) == renamed(yaml.safe_load(path.read_text()))


def test_conf_tree_has_the_yaml_files_and_no_other():
    want = {str(p.relative_to(JAX_CONF).with_suffix('')) for p in YAML_FILES}
    got = set(conf.ROOTS) | {f'{g}/{name}' for g, opts in conf.GROUPS.items() for name in opts}
    assert got == want
    assert len(conf.GROUPS['hamil/mol']) == 29


def _targets(node):
    if isinstance(node, dict):
        if '_target_' in node:
            yield node['_target_']
        for v in node.values():
            yield from _targets(v)
    elif isinstance(node, list):
        for v in node:
            yield from _targets(v)


@pytest.mark.parametrize('group', sorted(set(conf.GROUPS) - {'ansatz'}))
def test_targets_name_the_ports_objects(group):
    """Outside the ansatz trees (read by ``presets.ansatz_from_config``),
    every target of the tree resolves to an object of the port."""
    for target in _targets(conf.GROUPS[group]):
        assert target.startswith('deepqmc_tpu_torch.'), target
        assert callable(config.resolve_target(target)), target


def test_ansatz_trees_are_read():
    for name, tree in conf.GROUPS['ansatz'].items():
        assert config.port_target(tree['_target_']) in config.TREE_READERS, name


OVERRIDES = [
    [],
    ['hamil/mol=H2'],
    ['task.steps=5', '+task.max_eq_steps=7', 'task/opt=adamw'],
    ['ansatz=psiformer'],
    ['ansatz=ferminet', 'hamil/mol=LiH'],
    ['ansatz=deeperwin', 'hamil/mol=LiH'],
    ['hamil/mol=H2', 'task.steps=1', 'task.electron_batch_size=8', '+task.max_eq_steps=1',
     'task.pretrain_steps=null', 'task/opt=adamw', 'ansatz.n_determinants=2',
     'ansatz.omni_factory.embedding_dim=16', 'ansatz.omni_factory.gnn_factory.n_interactions=1'],
    ['task=train_psiformer', 'ansatz=psiformer', 'hamil/mol=H2O',
     'task.electron_batch_size=2048', 'task.steps=5', 'task.pretrain_steps=5',
     '+task.max_eq_steps=5', 'task.metric_logger_constructor=null',
     'task.h5_logger_constructor=null'],
    ['hamil/mol=ScO', '+hamil.ecp_type=ccECP', 'ansatz=psiformer', 'task=train_psiformer',
     'task.pretrain_steps=null'],
    ['task=evaluate', 'task.restdir=/some/run/training', '+task.steps=3'],
    ['task=restart', 'task.restdir=/some/run'],
    ['task=evaluate_excited', 'task.restdir=/some/run'],
    ['task=train_excited_psiformer', 'task.electronic_states=2',
     'task.pretrain_kwargs.scf_kwargs.cas=[4, 4]', 'task/sampler_factory=decorr_langevin'],
    ['task=train_ferminet', 'ansatz=ferminet', 'task.sampler_factory.elec_sampler.samplers=[]'],
    ['hamil=qc_loop_laplacian', 'hamil/mol=from_file', 'hamil.mol.file=/tmp/mol.yaml'],
    ['~task.mols', '~logging', 'task.pretrain_kwargs.scf_kwargs.basis=aug-cc-pVTZ',
     '+task.pretrain_kwargs.opt_kwargs.eps="1e-8"', 'task.seed=0x10'],
]


@pytest.mark.parametrize('overrides', OVERRIDES, ids=lambda o: ' '.join(o) or 'defaults')
def test_compose_matches_jax(overrides):
    want = jax_config.compose(overrides=overrides, user_conf_dir=None)
    assert config.compose(overrides=overrides) == renamed(want)


@pytest.mark.parametrize('override', ['task.not_a_key=1', 'nothing.here=2', 'hamil.mol.x.y=3'])
def test_unknown_key_raises(override):
    with pytest.raises(KeyError):
        jax_config.compose(overrides=[override], user_conf_dir=None)
    with pytest.raises(KeyError):
        config.compose(overrides=[override])


def test_compose_does_not_touch_the_tree():
    before = repr(conf.GROUPS['task']['train'])
    cfg = config.compose(overrides=['task.pretrain_kwargs.opt=lamb'])
    cfg['task']['steps'] = -1
    assert repr(conf.GROUPS['task']['train']) == before


# --- override values ---------------------------------------------------------

def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


_digits = st.text('0123456789', min_size=1, max_size=6)
_sign = st.sampled_from(['', '-', '+'])
_ints = st.one_of(
    st.integers(-10**9, 10**9).map(str),
    st.builds(lambda s, d: s + d, _sign, _digits),  # leading zeros: octal or strings
    st.builds(lambda s, d: f'{s}{d[:2]}_{d}', _sign, _digits),
    st.builds(lambda s, n: f'{s}0x{n:X}', _sign, st.integers(0, 2**20)),
    st.builds(lambda s, n: f'{s}0b{n:b}', _sign, st.integers(0, 2**10)),
    st.builds(lambda a, b: f'{a}:{b:02d}', st.integers(1, 99), st.integers(0, 59)),
)
_floats = st.one_of(
    st.floats(allow_nan=False, allow_infinity=False).map(repr),
    st.builds(lambda s, a, b: f'{s}{a}.{b}', _sign, _digits, _digits),
    st.builds(lambda s, a: f'{s}{a}.', _sign, _digits),
    st.builds(lambda a: f'.{a}', _digits),
    st.builds(lambda s, a, b, e, x: f'{s}{a}.{b}{e}{x}', _sign, _digits, _digits,
              st.sampled_from(['e', 'E', 'e-', 'e+', 'E-']), st.integers(0, 30)),
    st.builds(lambda s, a, e, x: f'{s}{a}{e}{x}', _sign, _digits,
              st.sampled_from(['e', 'e-', 'E+']), st.integers(0, 30)),  # no dot: a string
    st.sampled_from(['.inf', '-.inf', '+.Inf', '.NaN', '.nan', '.NAN', '1_000.5', '3.e-4']),
)
_words = st.sampled_from([
    'true', 'True', 'TRUE', 'false', 'False', 'FALSE', 'yes', 'No', 'ON', 'off', 'y', 'n',
    'null', 'Null', 'NULL', '~', 'none', 'sto-6g', 'aug-cc-pVTZ', 'ccECP', 'max_gap_std',
    '/tmp/run/training', 'deepqmc_tpu_torch.log.H5Logger', 'a b', 'x.y', 'lamb', 'nan', 'inf',
])
_plain = st.text('abcdefghijklmnopqrstuvwxyzABCDEFXYZ_', min_size=1, max_size=8)
_quoted = st.one_of(
    st.text('abc XYZ019:#,[]{}-.', max_size=8).map(lambda s: "'" + s + "'"),
    st.text('abc XYZ019:#,[]{}-.\'', max_size=8).map(lambda s: '"' + s + '"'),
    st.sampled_from(["'it''s'", '"a\\"b"', '"tab\\there"', '"lambda x: x"']),
)
_scalars = st.one_of(_ints, _floats, _words, _plain, _quoted)


def _flow(children):
    return st.lists(children, max_size=4).map(lambda xs: '[' + ', '.join(xs) + ']')


_values = st.recursive(_scalars, _flow, max_leaves=8)


@settings(max_examples=400, deadline=None, derandomize=True)
@given(_values)
def test_parse_value_matches_yaml(text):
    assert _same(config.parse_value(text), yaml.safe_load(text)), text


@pytest.mark.parametrize('text', ['1e-3', '3.e-4', '.5', '1_000', '017', '08', '0x1F', '1:30',
                                  '[a, b]', '[1, [2.5, "x, y"], null]', '[]', "'3'", 'Yes',
                                  '~', ' 5 ', '-x', 'a:b', 'a#b', '[1, 2,]'])
def test_parse_value_examples(text):
    assert _same(config.parse_value(text), yaml.safe_load(text)), text


@pytest.mark.parametrize('text', ['{a: 1}', 'a: b', '2001-12-14', '[1, 2', "'open", '&x',
                                  '- 1', 'x #c', '[a: 1]'])
def test_parse_value_refuses_the_rest(text):
    with pytest.raises(ValueError):
        config.parse_value(text)


# --- instantiation -----------------------------------------------------------

def test_resolvers_and_markers():
    assert config.instantiate({'f': '${eval:"lambda x: x + 1"}'})['f'](1) == 2
    assert config.instantiate({'task': {'evaluate': True}, 's': '${mode_subdir:}'})['s'] == \
        'evaluation'
    assert config.instantiate({'task': {'steps': 5}, 's': '${mode_subdir:}'})['s'] == 'training'
    assert config.instantiate({'s': '${process_idx_suffix:}'})['s'] == ''
    with pytest.raises(config.MissingValueError):
        config.instantiate({'x': '???'})
    node = {'a': {'b': 3}, 'c': '${a.b}'}
    assert config.instantiate(node)['c'] == 3


def test_reference_and_jax_targets_resolve_onto_the_port():
    from deepqmc_tpu_torch import fwdlap, nn
    from deepqmc_tpu_torch.kfac import KFAC
    from deepqmc_tpu_torch.optimizer import adamw
    from deepqmc_tpu_torch.physics import loop_laplacian

    for name, want in [('deepqmc.hkext.MLP', nn.MLP), ('haiku.Linear', nn.Linear),
                       ('kfac_jax.Optimizer', KFAC), ('deepqmc.molecule.Molecule', dqt.Molecule),
                       ('deepqmc_tpu.hamil.MolecularHamiltonian', dqt.MolecularHamiltonian),
                       ('deepqmc.physics.laplacian', loop_laplacian),
                       ('jax.numpy.tanh', fwdlap.tanh), ('optax.adamw', adamw),
                       ('deepqmc_tpu.molecule.Molecule.from_file', dqt.Molecule.from_file)]:
        assert config.resolve_target(name) == want, name
    assert config.resolve_target('deepqmc.sampling.MetropolisSampler').__module__.startswith(
        'deepqmc_tpu_torch.')


@pytest.mark.parametrize('overrides, valence', [
    (['hamil/mol=H2'], [1, 1]),
    (['hamil/mol=ScO', '+hamil.ecp_type=ccECP'], [11, 6]),
    (['hamil=qc_loop_laplacian', 'hamil/mol=LiH', '+hamil.ecp_type=ccECP'], [1, 1]),
])
def test_instantiate_hamiltonian(overrides, valence):
    cfg = config.compose(overrides=overrides)
    hamil = config.instantiate(cfg['task']['hamil'], root=cfg)
    assert isinstance(hamil, dqt.MolecularHamiltonian)
    np.testing.assert_array_equal(hamil.ns_valence, valence)
    jax_cfg = jax_config.compose(overrides=overrides, user_conf_dir=None)
    jax_hamil = jax_config.instantiate(jax_cfg['hamil'], root=jax_cfg)
    assert (hamil.n_up, hamil.n_down) == (jax_hamil.n_up, jax_hamil.n_down)
    np.testing.assert_allclose(hamil.mol.coords, np.asarray(jax_hamil.mol.coords), rtol=1e-15)


# --- molecule files ----------------------------------------------------------

@pytest.mark.parametrize('path', MOL_FILES, ids=lambda p: p.stem)
def test_molecule_file_reader_matches_yaml(path):
    assert read_molecule_file(path) == yaml.safe_load(path.read_text())
    got, want = dqt.Molecule.from_file(path), dqj.Molecule.from_file(str(path))
    np.testing.assert_array_equal(got.coords, np.asarray(want.coords))
    np.testing.assert_array_equal(got.charges, np.asarray(want.charges))
    assert (got.charge, got.spin) == (want.charge, want.spin)


BLOCK_FILE = """\
# a molecule with block lists
coords:
  - [0.0, 0.0, 0.0]   # first atom
  - [
      1.5, 0.0,
      -2.0e+0,
    ]
  - [0, 1_000.25, .5]
charges:
- 3
- 1
- 1
charge: 1  # cation
spin: 0
unit: angstrom
"""


def test_block_list_file_and_dataset(tmp_path):
    (tmp_path / 'block.yaml').write_text(BLOCK_FILE)
    assert read_molecule_file(tmp_path / 'block.yaml') == yaml.safe_load(BLOCK_FILE)
    for f in MOL_FILES[:5]:
        (tmp_path / f.name).write_text(f.read_text())
    got = read_molecule_dataset(tmp_path, whitelist='^(B|block|C.*)$')
    want = dqj.molecule.read_molecule_dataset(tmp_path, whitelist='^(B|block|C.*)$')
    assert list(got) == list(want)
    for name in got:
        np.testing.assert_array_equal(got[name].coords, np.asarray(want[name].coords))
    cfg = config.compose(overrides=['hamil/mol=from_file',
                                    f'hamil.mol.file={tmp_path / "block.yaml"}'])
    mol = config.instantiate(cfg['hamil']['mol'], root=cfg)
    np.testing.assert_array_equal(mol.charges, [3, 1, 1])


@pytest.mark.parametrize('text', ['coords: {a: 1}\n', 'name: [H, 1]\n', 'a:\n  b: 1\n',
                                  'coords: [[0, 0, 0]\n', 'x: 1\nx: 2\n', '- 1\n'])
def test_molecule_file_reader_refuses_the_rest(tmp_path, text):
    (tmp_path / 'bad.yaml').write_text(text)
    with pytest.raises(ValueError):
        read_molecule_file(tmp_path / 'bad.yaml')


# --- validate_kwargs ---------------------------------------------------------

@pytest.mark.parametrize('task, n_warnings', [
    ({'electron_batch_size': 1000, 'molecule_batch_size': 1}, 0),
    ({'loss_function_factory': {'spin_penalty': 1.0}, 'pretrain_steps': 10,
      'pretrain_kwargs': {'scf_kwargs': {'cas': [4, 4]}}, 'electron_batch_size': 8}, 1),
    ({'electronic_states': 2, 'pretrain_kwargs': {'scf_kwargs': {}},
      'electron_batch_size': 8}, 1),
])
def test_validate_kwargs_warns_as_jax(task, n_warnings, caplog):
    with caplog.at_level(logging.WARNING):
        jax_validate_kwargs(task)
    want = [r.message for r in caplog.records if r.name.startswith('deepqmc_tpu.')]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        got = validate_kwargs(task)
    assert got == want and len(got) == n_warnings
    assert [r.message for r in caplog.records if r.name.startswith('deepqmc_tpu_torch')] == got


def test_validate_kwargs_molecule_batch():
    """The JAX package asserts; the port raises a ``ValueError`` with its message."""
    task = {'mols': None, 'molecule_batch_size': 2, 'electron_batch_size': 8}
    with pytest.raises(AssertionError, match=r'Molecule batch size \(2\)'):
        jax_validate_kwargs(task)
    with pytest.raises(ValueError, match=r'Molecule batch size \(2\) is larger than the '
                                         r'number of molecules in the dataset \(1\)'):
        validate_kwargs(task)
    assert validate_kwargs({**task, 'molecule_batch_size': 1}) == []


def test_validate_kwargs_walker_divisibility(monkeypatch):
    """Walkers that the processes do not split evenly: an error on both sides."""
    from deepqmc_tpu_torch import validate_kwargs as port_rules

    task = {'electron_batch_size': 9, 'molecule_batch_size': 1}
    assert validate_kwargs(task) == []  # one process takes any batch
    monkeypatch.setattr(port_rules, 'get_process_count', lambda: 2)
    with pytest.raises(ValueError, match=r'Electron batch size \(9\) cannot be evenly split '
                                         r'across 2 devices'):
        validate_kwargs(task)
    assert validate_kwargs({**task, 'electron_batch_size': 8}) == []

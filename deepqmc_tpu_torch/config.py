"""Config engine of the port (counterpart of ``deepqmc_tpu/config.py``):
composition of the configuration tree of :mod:`.conf` and instantiation of
its ``_target_`` nodes.

The same semantics as the JAX package's engine, on Python data instead of
YAML files:

- ``defaults`` lists with config groups (``task``, ``ansatz``, ``hamil``,
  ``task/opt``, ``task/sampler_factory``, ``hamil/mol``), expanded as
  ``_process_defaults`` does there;
- the override grammar ``key.sub=value``, ``group=option``,
  ``group/sub=option``, ``+new.key=value``, ``~key``; an unknown key raises;
  values are read by :func:`parse_value`, which gives what ``yaml.safe_load``
  gives for the scalars and flow lists an override holds;
- ``_target_`` / ``_partial_`` nodes with recursive instantiation,
  ``${path.to.key}`` interpolation, the ``${eval:"..."}``,
  ``${process_idx_suffix:}`` and ``${mode_subdir:}`` resolvers and ``???``
  markers;
- targets of the JAX package and of the DeepQMC reference (``deepqmc_tpu.*``,
  ``deepqmc.*``, ``haiku.Linear``, ``kfac_jax.Optimizer``, ...) resolve onto
  the port by :func:`port_target`, so their configs run here.

A node whose target is in :data:`TREE_READERS` is not called with its
instantiated keywords: its reader gets the node as composed.  The ansatz
trees take this route (:func:`.presets.ansatz_from_config`), which
instantiates the tree's nodes and builds the wave function from them inside
a seeded generator, as the presets do.
"""

import copy
import importlib
import re
from functools import partial
from typing import Optional

__all__ = ['MissingValueError', 'compose', 'instantiate', 'parse_value', 'port_target']


class MissingValueError(ValueError):
    pass


MISSING = '???'

# targets with no counterpart of the same path in the port
TARGET_ALIASES = {
    'deepqmc.hkext.MLP': 'deepqmc_tpu_torch.nn.MLP',
    'deepqmc.hkext.GLU': 'deepqmc_tpu_torch.nn.GLU',
    'deepqmc.hkext.SumPool': 'deepqmc_tpu_torch.nn.SumPool',
    'deepqmc.hkext.Identity': 'deepqmc_tpu_torch.nn.Identity',
    'deepqmc.hkext.ResidualConnection': 'deepqmc_tpu_torch.nn.ResidualConnection',
    'deepqmc.hkext.ssp': 'deepqmc_tpu_torch.nn.ssp',
    'deepqmc.physics.laplacian': 'deepqmc_tpu_torch.physics.loop_laplacian',
    'haiku.Linear': 'deepqmc_tpu_torch.nn.Linear',
    'kfac_jax.Optimizer': 'deepqmc_tpu_torch.kfac.KFAC',
    'jax.numpy.tanh': 'deepqmc_tpu_torch.fwdlap.tanh',
    'jax.nn.sigmoid': 'deepqmc_tpu_torch.fwdlap.sigmoid',
    'jax.nn.silu': 'deepqmc_tpu_torch.fwdlap.silu',
    'jax.nn.softplus': 'deepqmc_tpu_torch.fwdlap.softplus',
    'jax.numpy.ones': 'deepqmc_tpu_torch.nn.ones_init',
    'optax.adamw': 'deepqmc_tpu_torch.optimizer.adamw',
}
PREFIXES = ('deepqmc_tpu.', 'deepqmc.')

# target -> reader of the composed node (module path, name)
TREE_READERS = {
    'deepqmc_tpu_torch.wf.NeuralNetworkWaveFunction': ('deepqmc_tpu_torch.presets',
                                                       'ansatz_from_config'),
}


def port_target(path: str) -> str:
    """The port's name for a target of the JAX package or the reference."""
    path = TARGET_ALIASES.get(path, path)
    for prefix in PREFIXES:
        if path.startswith(prefix):
            return TARGET_ALIASES.get(path, 'deepqmc_tpu_torch.' + path[len(prefix):])
    return path


def resolve_target(path: str):
    """Import the object named by a dotted path (after :func:`port_target`)."""
    path = port_target(path)
    module_path, _, name = path.rpartition('.')
    try:
        module = importlib.import_module(module_path)
    except ImportError:
        # the last two components may be Class.method
        mod2, _, cls = module_path.rpartition('.')
        return getattr(getattr(importlib.import_module(mod2), cls), name)
    return getattr(module, name)


# --- override values: YAML 1.1's implicit scalars (PyYAML's resolver) --------

_BOOL = re.compile(r'^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE'
                   r'|on|On|ON|off|Off|OFF)$')
_FLOAT = re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X)
_INT = re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X)
_NULL = re.compile(r'^(?:~|null|Null|NULL|)$')
_TIMESTAMP = re.compile(r'^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?')
_INDICATORS = set('[]{},#&*!|>\'"%@`')
_ESCAPES = {'"': '"', '\\': '\\', '/': '/', 'n': '\n', 't': '\t', 'r': '\r', '0': '\0',
            'b': '\b', 'f': '\f', 'a': '\a', 'v': '\v', 'e': '\x1b', ' ': ' '}


def _sexagesimal(digits: str, convert):
    value = 0
    for part in digits.split(':'):
        value = value * 60 + convert(part)
    return value


def _int(text: str) -> int:
    text = text.replace('_', '')
    sign = -1 if text[0] == '-' else 1
    text = text.lstrip('+-')
    if text == '0':
        return 0
    if text.startswith('0b'):
        return sign * int(text[2:], 2)
    if text.startswith('0x'):
        return sign * int(text[2:], 16)
    if text[0] == '0':
        return sign * int(text, 8)
    if ':' in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _float(text: str) -> float:
    text = text.replace('_', '').lower()
    sign = -1.0 if text[0] == '-' else 1.0
    text = text.lstrip('+-')
    if text == '.inf':
        return sign * float('inf')
    if text == '.nan':
        return float('nan')
    if ':' in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def _plain_scalar(text: str):
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ('yes', 'true', 'on')
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if _TIMESTAMP.match(text):
        raise ValueError(f'override value {text!r}: timestamps are not supported')
    if text[0] in _INDICATORS or text[0] in '-?:' and (len(text) == 1 or text[1] == ' ') or (
            ': ' in text or ' #' in text or text.endswith(':')):
        raise ValueError(f'override value {text!r}: not a scalar or flow list this parser '
                         'reads; quote it')
    return text


class _Reader:
    """A flow list or a quoted or plain scalar, from ``text[pos:]``."""

    def __init__(self, text):
        self.text, self.pos = text, 0

    def fail(self, what):
        raise ValueError(f'override value {self.text!r}: {what} at {self.pos}')

    def skip_space(self):
        while self.pos < len(self.text) and self.text[self.pos] in ' \t':
            self.pos += 1

    def value(self, in_flow):
        self.skip_space()
        c = self.text[self.pos:self.pos + 1]
        if c == '[':
            return self.flow_list()
        if c == "'":
            return self.single_quoted()
        if c == '"':
            return self.double_quoted()
        if c == '{':
            self.fail('flow mappings are not supported')
        start = self.pos
        stop = ',[]{}' if in_flow else ''
        while self.pos < len(self.text) and self.text[self.pos] not in stop:
            self.pos += 1
        text = self.text[start:self.pos].strip()
        if in_flow and text == '':
            self.fail('empty entry')
        return _plain_scalar(text)

    def flow_list(self):
        self.pos += 1
        items = []
        while True:
            self.skip_space()
            if self.text[self.pos:self.pos + 1] == ']':
                self.pos += 1
                return items
            items.append(self.value(in_flow=True))
            self.skip_space()
            c = self.text[self.pos:self.pos + 1]
            if c == ',':
                self.pos += 1
            elif c != ']':
                self.fail("expected ',' or ']'")

    def single_quoted(self):
        out, self.pos = [], self.pos + 1
        while True:
            if self.pos >= len(self.text):
                self.fail('unterminated quote')
            c = self.text[self.pos]
            if c == "'":
                if self.text[self.pos + 1:self.pos + 2] == "'":
                    out.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return ''.join(out)
            out.append(c)
            self.pos += 1

    def double_quoted(self):
        out, self.pos = [], self.pos + 1
        while True:
            if self.pos >= len(self.text):
                self.fail('unterminated quote')
            c = self.text[self.pos]
            if c == '"':
                self.pos += 1
                return ''.join(out)
            if c == '\\':
                esc = self.text[self.pos + 1:self.pos + 2]
                if esc not in _ESCAPES:
                    self.fail(f'escape \\{esc} is not supported')
                out.append(_ESCAPES[esc])
                self.pos += 2
                continue
            out.append(c)
            self.pos += 1


def parse_value(text: str):
    """An override's value as ``yaml.safe_load`` reads it: YAML 1.1's ints,
    floats, booleans and nulls, quoted strings, plain strings and flow lists
    of these.  Anything else raises ``ValueError``."""
    text = text.strip()
    if text == '':
        return None
    reader = _Reader(text)
    if text[0] in '["\'':
        value = reader.value(in_flow=False)
        reader.skip_space()
        if reader.pos != len(text):
            reader.fail('trailing characters')
        return value
    return _plain_scalar(text)


# --- composition --------------------------------------------------------------


def _conf():
    from . import conf

    return conf


def _deep_merge(base, override):
    """Merge override into base (dicts recursively, others replaced)."""
    if isinstance(base, dict) and isinstance(override, dict):
        out = dict(base)
        for k, v in override.items():
            out[k] = _deep_merge(out[k], v) if k in out else v
        return out
    return override


def _load_group_config(groups, group: str, name: str):
    try:
        return copy.deepcopy(groups[group][name])
    except KeyError:
        raise FileNotFoundError(f'No config {group}/{name} in the port\'s conf tree') from None


def _process_defaults(cfg, group_prefix: str, groups, selections: dict):
    """Expand a node's ``defaults`` list (``deepqmc_tpu.config._process_defaults``)."""
    if not isinstance(cfg, dict) or 'defaults' not in cfg:
        return cfg
    cfg = dict(cfg)
    defaults = cfg.pop('defaults')
    merged: dict = {}
    self_seen = False
    for entry in defaults:
        if entry == '_self_':
            merged = _deep_merge(merged, cfg)
            self_seen = True
            continue
        if isinstance(entry, str):
            continue  # e.g. 'optional ...' markers: ignored
        (key, name), = entry.items()
        if key.startswith('override hydra') or key.startswith('optional'):
            continue
        sub_group = f'{group_prefix}/{key}' if group_prefix else key
        name = selections.pop(sub_group, name)
        if name is None:
            continue
        sub_cfg = _load_group_config(groups, sub_group, name)
        sub_cfg = _process_defaults(sub_cfg, sub_group, groups, selections)
        merged = _deep_merge(merged, {key.split('@')[0]: sub_cfg})
    if not self_seen:
        merged = _deep_merge(merged, cfg)
    return merged


def _set_path(cfg: dict, dotted: str, value, *, allow_new: bool):
    keys = dotted.split('.')
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            if not allow_new:
                raise KeyError(f'Unknown config path: {dotted}')
            node[k] = {}
        node = node[k]
    if not allow_new and keys[-1] not in node:
        raise KeyError(f'Unknown config key: {dotted} (prefix with + to add new keys)')
    node[keys[-1]] = value


def _delete_path(cfg: dict, dotted: str):
    keys = dotted.split('.')
    node = cfg
    for k in keys[:-1]:
        node = node[k]
    node.pop(keys[-1], None)


def apply_override(cfg: dict, override: str):
    """Apply one value override (not a group selection) to the composed config."""
    if override.startswith('~'):
        _delete_path(cfg, override[1:].replace('/', '.'))
        return
    allow_new = override.startswith('+')
    if allow_new:
        override = override[1:]
    key, _, raw_value = override.partition('=')
    value = parse_value(raw_value) if raw_value != '' else ''
    _set_path(cfg, key.replace('/', '.'), value, allow_new=allow_new)


def compose(config_name: str = 'config', overrides: Optional[list[str]] = None) -> dict:
    """The composed config tree of :mod:`.conf` with ``overrides`` applied."""
    conf = _conf()
    all_groups = conf.GROUPS
    if config_name not in conf.ROOTS:
        raise FileNotFoundError(f'{config_name} is not a root config of the port')
    root = copy.deepcopy(conf.ROOTS[config_name])
    selections, value_overrides = {}, []
    for override in overrides or []:
        key, _, raw_value = override.lstrip('+~').partition('=')
        if (not override.startswith('~') and '.' not in key and '=' not in raw_value
                and raw_value in all_groups.get(key, {})):
            selections[key] = raw_value
        else:
            value_overrides.append(override)
    cfg = _process_defaults(root, '', all_groups, selections)
    for group, name in selections.items():
        # selections for groups absent from any defaults list: set directly
        sub_cfg = _process_defaults(_load_group_config(all_groups, group, name), group,
                                    all_groups, {})
        _set_path(cfg, group.replace('/', '.'), sub_cfg, allow_new=True)
    for override in value_overrides:
        apply_override(cfg, override)
    return cfg


# --- instantiation ------------------------------------------------------------

_INTERP_RE = re.compile(r'^\$\{([^}]*)\}$')


def process_idx_suffix() -> str:
    """``_{rank}`` in a run of several processes, else '' (one process here)."""
    return ''


def _resolve_interpolation(expr: str, root):
    if expr.startswith('eval:'):
        return eval(parse_value(expr[len('eval:'):]))  # noqa: S307 (the reference's resolver)
    if expr.rstrip(':') == 'process_idx_suffix':
        return process_idx_suffix()
    if expr.rstrip(':') == 'mode_subdir':
        try:
            evaluate = bool(root['task']['evaluate'])
        except (KeyError, TypeError):
            evaluate = False
        return 'evaluation' if evaluate else 'training'
    node = root
    for k in expr.split('.'):
        node = node[k]
    return instantiate(node, root=root)


def instantiate(node, root=None, **kwargs):
    """Recursively turn ``_target_`` config nodes into live objects;
    ``kwargs`` go to the top node's target."""
    if root is None:
        root = node
    if isinstance(node, str):
        m = _INTERP_RE.match(node)
        if m:
            return _resolve_interpolation(m.group(1), root)
        if node == MISSING:
            raise MissingValueError('Mandatory value ??? was not provided')
        return node
    if isinstance(node, list):
        return [instantiate(v, root=root) for v in node]
    if not isinstance(node, dict):
        return node
    if '_target_' in node:
        name = port_target(node['_target_'])
        if name in TREE_READERS:
            module, reader = TREE_READERS[name]
            return getattr(importlib.import_module(module), reader)(node, **kwargs)
        target = resolve_target(name)
        node_kwargs = {
            k: instantiate(v, root=root)
            for k, v in node.items()
            if k not in ('_target_', '_partial_', '_convert_')
        }
        node_kwargs.update(kwargs)
        if node.get('_partial_', False):
            return partial(target, **node_kwargs)
        return target(**node_kwargs)
    return {k: instantiate(v, root=root) for k, v in node.items()}

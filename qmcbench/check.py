"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``reference/``) run on the same inputs.

The inputs are the benchmark's own (the weights it drew, the molecule of
the configuration) and the walkers the program's sampler produced, which
the reference takes as the step's rows.  The reference recomputes
everything the program derived from them.

Per walker, a float32 computation's rounding is scaled by the reference's
own float32 value (TF32 off) at that walker: ``eloc_rule`` and ``psi_rule``
are the largest |x - x_64| / (|x_32 - x_64| + 1e-6 s) over the walkers,
``s`` the sum of the local energy's terms' magnitudes, or max(1, |log|psi||)
(a sign of psi unlike the reference's reads infinite).

Training cells (the first ``checked_steps`` steps of the very run the window
continues, and the walkers of the window's last step):
- ``loss_gap``: the worst step's |loss - reference| / max(1, |reference|);
- ``eloc_rule`` over those steps' walkers;
- ``grad_gap``: the first step's gradient as KFAC receives it, by the worst
  leaf: |norm - reference norm| / max(reference norm, the median leaf's);
- ``update_gap``: the change of the parameters after the checked steps, by
  the worst leaf as above; leaves whose reference gradient is under a
  thousandth of the median leaf's are left out (they move by round-off);
- ``psi_rule`` at the window's last walkers, with the final parameters.

Evaluation cells (rows of every window step, a sample drawn from the seed):
``eloc_rule`` and ``psi_rule``.  The other numbers are readings for
``control.py``.
"""

import math

import numpy as np
import torch

from .reference import energy, kfac, nets

__all__ = ['compare', 'reference_side']


def _setup(dtype, tf32):
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision('high' if tf32 else 'highest')


def _to(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _to(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dtype, device) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree


def molecule(cfg, dtype, device):
    mol = cfg['molecule']
    return (torch.tensor(mol['coords'], dtype=dtype, device=device),
            torch.tensor(mol['charges'], dtype=dtype, device=device))


def reference_side(data, cfg, traffic, device, dtype=torch.float64, tf32=False, with_f32=True):
    """What the reference gives on the program's inputs ``data``, in the
    layout of the program's captures (``dtype``/``tf32`` as asked: float64 for
    the truth, float32 with TF32 for the control).  The truth also carries
    the reference's own float32 values (TF32 off) of the local energies and
    of log|psi|: their distance from float64 is each walker's scale of a
    float32 computation's rounding.  The plain float32 reference (TF32 off)
    is a second witness of what float32 alone gives."""
    truth = with_f32 and dtype == torch.float64 and not tf32
    _setup(dtype, tf32)
    data = _to(data, dtype, device)
    R, Z = molecule(cfg, dtype, device)
    R32, Z32 = molecule(cfg, torch.float32, device)
    f32 = lambda t: _to(t, torch.float32, device)  # noqa: E731
    out = {}
    if traffic['optimizer'] is not None:
        opt = traffic['optimizer']
        ref = kfac.KFACReference(data['P0'], cfg, R, Z, opt, traffic['clip'])
        out['loss'], out['E'], out['scale'], out['E32'] = [], [], [], []
        for k, r in enumerate(data['r']):
            if truth:
                out['E32'].append(energy.local_energy(f32(ref.P), cfg, f32(r), R32, Z32))
            loss, E, scale, grads = ref.step(r)
            out['loss'].append(loss)
            out['E'].append(E)
            out['scale'].append(scale)
            if k == 0:
                out['grads'] = grads
        out['P3'] = ref.P
        P = data['P_final']
    else:
        P = data['P0']
        E, scale = energy.local_energy(P, cfg, data['rows_r'], R, Z, with_scale=True)
        out['E'], out['scale'] = [E], [scale]
        if truth:
            out['E32'] = [energy.local_energy(f32(P), cfg, f32(data['rows_r']), R32, Z32)]
    with torch.no_grad():
        out['sign'], out['log'] = nets.log_psi(P, cfg, data['rows_r'], R)
        if truth:
            out['sign32'], out['log32'] = nets.log_psi(f32(P), cfg, f32(data['rows_r']), R32)
    if not truth:
        out.pop('E32', None)
    _setup(torch.float64, False)
    return _to(out, torch.float64, 'cpu')


def _leaf_gap(prog, ref, keep=None):
    """The worst leaf's |norm - reference norm| over max(reference norm, median leaf's)."""
    keys = [k for k in ref if keep is None or k in keep]
    pn = {k: float(torch.linalg.vector_norm(prog[k])) for k in keys}
    rn = {k: float(torch.linalg.vector_norm(ref[k])) for k in keys}
    median = float(np.median(list(rn.values())))
    return max(abs(pn[k] - rn[k]) / max(rn[k], median) for k in keys)


def _rel(a, b):
    return (a - b).abs() / b.abs().clamp(min=1)


def compare(prog, truth, P0=None):
    """The numbers compared, from the program's captures ``prog`` and the
    reference's ``truth`` (both in :func:`reference_side`'s layout); the
    limits say which of them decide ``correct``, the rest are readings."""
    prog, truth = _to(prog, torch.float64, 'cpu'), _to(truth, torch.float64, 'cpu')
    out = {}
    E_p, E_r, scale = (torch.cat([x.reshape(-1) for x in xs])
                       for xs in (prog['E'], truth['E'], truth['scale']))
    out['eloc_median'] = float(_rel(E_p, E_r).median())
    if 'loss' in truth:
        out['loss_gap'] = max(float(_rel(torch.as_tensor(p), torch.as_tensor(t)))
                              for p, t in zip(prog['loss'], truth['loss']))
        # the first step's alone: the weights are the same on both sides
        out['loss_gap_0'] = float(_rel(torch.as_tensor(prog['loss'][0]), truth['loss'][0]))
        out['eloc_median_0'] = float(_rel(prog['E'][0].reshape(-1), truth['E'][0]).median())
        out['grad_gap'] = _leaf_gap(prog['grads'], truth['grads'])
        norms = {k: float(torch.linalg.vector_norm(g)) for k, g in truth['grads'].items()}
        floor = 1e-3 * float(np.median(list(norms.values())))
        keep = {k for k, v in norms.items() if v >= floor}
        P0 = _to(P0, torch.float64, 'cpu')
        out['update_gap'] = _leaf_gap({k: prog['P3'][k] - P0[k] for k in keep},
                                      {k: truth['P3'][k] - P0[k] for k in keep})
    if 'E32' in truth:
        E32 = torch.cat([x.reshape(-1) for x in truth['E32']])
        out['eloc_rule'] = float(((E_p - E_r).abs() / ((E32 - E_r).abs() + 1e-6 * scale)).max())
        out['ref32_eloc_median'] = float(_rel(E32, E_r).median())
        floor = 1e-6 * truth['log'].abs().clamp(min=1)
        rule = (prog['log'] - truth['log']).abs() / ((truth['log32'] - truth['log']).abs() + floor)
        rule[prog['sign'] != truth['sign']] = float('inf')
        out['psi_rule'] = float(rule.max())
    return {k: v if math.isfinite(v) else float('inf') for k, v in out.items()}


def worst_leaves(prog, truth, P0):
    """The leaves that read worst in ``grad_gap`` and ``update_gap`` (for the readings)."""
    def worst(p, r):
        n = lambda t: float(torch.linalg.vector_norm(t))  # noqa: E731
        median = float(np.median([n(v) for v in r.values()]))
        return max(r, key=lambda k: abs(n(p[k]) - n(r[k])) / max(n(r[k]), median))
    prog, truth = _to(prog, torch.float64, 'cpu'), _to(truth, torch.float64, 'cpu')
    P0 = _to(P0, torch.float64, 'cpu')
    return {'grad': worst(prog['grads'], truth['grads']),
            'update': worst({k: prog['P3'][k] - P0[k] for k in P0},
                            {k: truth['P3'][k] - P0[k] for k in P0})}

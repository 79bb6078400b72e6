"""The port's forward-Laplacian op rules against nested autograd.

Each rule of ``deepqmc_tpu_torch.fwdlap`` propagates (value, Jacobian,
Laplacian); here small scalar functions of a seeded input built from those
ops are evaluated through ``FL.seed`` and compared with ``torch.func``'s
gradient and Hessian trace, at float64 with relative tolerance 1e-12 (a few
chained ops, so float64 rounding only).  The elementwise rules of softplus,
sigmoid and silu carry their own first and second derivatives, so they
hold where a composition through ``exp`` would overflow.
"""

import numpy as np
import pytest
import torch

from deepqmc_tpu_torch import fwdlap as fl

RTOL = 1e-12
W = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 4)))
C = torch.as_tensor(np.random.default_rng(1).uniform(0.5, 1.5, size=(2, 4)))

FUNCTIONS = {
    'exp_tanh': lambda x: fl.exp(fl.tanh(x @ W)),
    'log_sqrt': lambda x: fl.log(fl.sqrt(1.5 + x * x)),
    'log1p_abs': lambda x: fl.log1p(fl.abs(x @ W)),
    'pow': lambda x: (1.2 + x * x) ** 1.5,
    'mul_div': lambda x: (x @ W) * fl.tanh(x @ W) / (2 + (x * x).sum(-1, keepdim=True)),
    'rdiv_const': lambda x: 3.0 / (C + (x @ W) ** 2),
    'sub_neg': lambda x: -(x @ W) - C * fl.exp(-x @ W),
    'index_cat': lambda x: fl.cat([x[..., 0, :], x[..., 1, :] * x[..., 0, :],
                                   torch.ones(3, dtype=x.dtype)], -1),
    'shape_ops': lambda x: (x[..., :, None] * x[..., None, :]).flatten(-2).unflatten(-1, (3, 3))
    .sum(-1, keepdim=True).squeeze(-1),
    'mha_core': lambda x: fl.mha_core(x @ W, fl.tanh(x @ W), x @ W * 0.5, 2),
    'mha_core_masked': lambda x: fl.mha_core(x @ W, fl.tanh(x @ W), x @ W * 0.5, 2,
                                             mask=torch.tensor([[True, False], [True, True]])),
    # the activations of DeepErwin and the embeddings' MLPs, also where exp(x) overflows
    'softplus_ssp': lambda x: fl.softplus(x @ W) * (1 + fl.softplus(800 * (x @ W) - 2e3)),
    'sigmoid': lambda x: fl.sigmoid(x @ W) * fl.sigmoid(-40 * (x @ W)),
    'silu': lambda x: fl.silu(x @ W) + fl.silu(50 * (x @ W)),
    'amin_transpose': lambda x: (fl.amin(x[..., :, None] * W, -2) * (x @ W)).transpose(-1, -2),
}


@pytest.mark.parametrize('name', sorted(FUNCTIONS))
def test_rule_matches_autograd(name):
    f = FUNCTIONS[name]
    x0 = torch.as_tensor(np.random.default_rng(2).normal(size=(2, 2, 3)))  # [B, 2, 3]

    def scalar(x):
        y = f(x)
        while y.dim() > 1:
            y = y.sum(-1)
        return y

    with torch.inference_mode():
        out = scalar(fl.FL.seed(x0))
    for b in range(x0.shape[0]):
        def one(xb):
            return scalar(xb.reshape(1, 2, 3))[0]

        flat = x0[b].reshape(-1)
        grad = torch.func.grad(one)(flat)
        lap = torch.func.hessian(one)(flat).diagonal().sum()
        torch.testing.assert_close(out.jac[b], grad, rtol=RTOL, atol=RTOL)
        torch.testing.assert_close(out.lap[b], lap, rtol=RTOL, atol=RTOL)
        torch.testing.assert_close(out.x[b], one(flat), rtol=RTOL, atol=RTOL)


def test_plain_tensors_pass_through():
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(2, 2, 3)))
    for f in FUNCTIONS.values():
        out = f(x)
        assert torch.is_tensor(out)
        with torch.inference_mode():
            torch.testing.assert_close(f(fl.FL.seed(x)).x, out, rtol=RTOL, atol=RTOL)

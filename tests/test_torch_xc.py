"""The port's XC functionals against the JAX package: energy density and
its derivatives of each B3LYP component and of the compounds, and the
functional-name parser."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_tpu.dft import xc as jax_xc

from pyscf_tpu_torch.dft import numint, xc

torch.set_num_threads(1)

NAMES = ['SLATER', 'VWN5', 'VWN3', 'B88', 'LYP', 'b3lypg', 'b3lyp5', 'blyp',
         'lda,vwn', 'lda,vwn_rpa', '0.2*HF + 0.8*B88, LYP']


def _inputs():
    """Seeded rho in [1e-10, 1e2] and sigma in [1e-20, 1e3], log-uniform,
    plus the mask edge: rho just above RHO_THR, sigma at SIGMA_FLOOR."""
    rng = np.random.default_rng(7)
    rho = 10.0 ** rng.uniform(-10, 2, 400)
    sigma = 10.0 ** rng.uniform(-20, 3, 400)
    rho = np.concatenate([rho, [numint.RHO_THR * (1 + 1e-9), 2e-10, 1e-9,
                                1e2]])
    sigma = np.concatenate([sigma, [numint.SIGMA_FLOOR] * 2, [1e-20, 1e3]])
    return rho, sigma


def _jax_closed(name, rho, sigma):
    f = jax_xc.parse_xc(name)

    def edens(r, s):
        return f.exc_density(0.5 * r, 0.5 * r, 0.25 * s, 0.25 * s, 0.25 * s)

    r, s = jnp.asarray(rho), jnp.asarray(sigma)
    vr, vs = jax.grad(lambda a, b: jnp.sum(edens(a, b)), argnums=(0, 1))(r, s)
    return np.asarray(edens(r, s)), np.asarray(vr), np.asarray(vs)


def _port_closed(name, rho, sigma):
    f = xc.parse_xc(name)
    r = torch.as_tensor(rho).requires_grad_()
    s = torch.as_tensor(sigma).requires_grad_()
    e = numint.edens_closed(f, r, s)
    vr, vs = torch.autograd.grad(e.sum(), (r, s), allow_unused=True)
    vs = torch.zeros_like(s) if vs is None else vs
    return e.detach().numpy(), vr.numpy(), vs.numpy()


@pytest.mark.parametrize('name', NAMES)
def test_energy_and_derivatives_match_jax(name):
    rho, sigma = _inputs()
    for got, ref in zip(_port_closed(name, rho, sigma),
                        _jax_closed(name, rho, sigma)):
        assert np.all(np.isfinite(got))
        assert np.all(np.abs(got - ref) <= 1e-12 * np.abs(ref) + 1e-300)


@pytest.mark.parametrize('name,hyb,family', [
    ('B3LYPG', 0.2, xc.GGA), ('b3lyp', 0.2, xc.GGA), ('LDA,VWN', 0.0, xc.LDA),
    ('svwn', 0.0, xc.LDA), ('0.25*HF + 0.75*B88, LYP', 0.25, xc.GGA)])
def test_parse_matches_jax(name, hyb, family):
    got, ref = xc.parse_xc(name), jax_xc.parse_xc(name)
    assert got.hyb == ref.hyb == xc.hybrid_coeff(name) == hyb
    assert got.family == ref.family == family
    assert [c for c, _, _ in got.terms] == [c for c, _, _ in ref.terms]
    assert xc.rsh_coeff(name) == ref.rsh == (0.0, 0.0, 0.0)


@pytest.mark.parametrize('name', ['pbe', 'camb3lyp', 'b2plyp', 'tpss',
                                  'wb97x-v', 'xalpha', 'b88,p86'])
def test_unported_functionals_raise(name):
    with pytest.raises(NotImplementedError, match='queue 1 step 9'):
        xc.parse_xc(name)

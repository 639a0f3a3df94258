"""The port's XC functionals against the JAX package: energy density and
its derivatives of each B3LYP and PBE component and of the compounds
(the B3LYP family's JAX values as tests/port_refs_record.py xc_refs
recorded them, a few seconds of eager dispatch each; the PBE family
live, and b3lypg live against the xc_funcs.cuh harness in
tests/test_torch_csrc_host.py), the open-shell PBE components, and the
functional-name parser."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_tpu.dft import xc as jax_xc

from pyscf_tpu_torch import refs
from pyscf_tpu_torch.dft import numint, xc

torch.set_num_threads(1)

NAMES = ['SLATER', 'VWN5', 'VWN3', 'B88', 'LYP', 'b3lypg', 'b3lyp5', 'blyp',
         'lda,vwn', 'lda,vwn_rpa', '0.2*HF + 0.8*B88, LYP', 'PBE_X']
# PBE correlation's eps + H cancels to rounding where the reduced gradient
# is large (H -> -eps): these are held to 1e-12 of the value plus the
# point's energy-density scale (_scaled_gate)
PBE_NAMES = ['PBE_C', 'pbe', 'pbe0']


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
                        np.load(refs.PORT_REFS)[f'xc_closed_{name}']):
        assert np.all(np.isfinite(got))
        assert np.all(np.abs(got - ref) <= 1e-12 * np.abs(ref) + 1e-300)


def _scaled_gate(got, ref, scale):
    """|got - ref| <= 1e-12 (|ref| + scale) elementwise, finite."""
    assert np.all(np.isfinite(got))
    assert np.all(np.abs(got - ref) <= 1e-12 * (np.abs(ref) + scale))


@pytest.mark.parametrize('name', PBE_NAMES)
def test_pbe_energy_and_derivatives_match_jax(name):
    """The closed-shell PBE family against the JAX package's on the same
    points (tests/port_refs_record.py xc_refs recorded them; the open shell
    stays live, test_open_shell_pbe_matches_jax): e_xc, vrho and vsigma to
    1e-12 of their size plus the scales rho^(4/3), rho^(1/3) and
    rho^(4/3)/sigma."""
    rho, sigma = _inputs()
    s43 = rho ** (4.0 / 3.0)
    for got, ref, scale in zip(_port_closed(name, rho, sigma),
                               np.load(refs.PORT_REFS)[f'xc_closed_{name}'],
                               (s43, s43 / rho, s43 / sigma)):
        _scaled_gate(got, ref, scale)


@pytest.mark.parametrize('name,hyb,family', [
    ('B3LYPG', 0.2, xc.GGA), ('b3lyp', 0.2, xc.GGA), ('LDA,VWN', 0.0, xc.LDA),
    ('svwn', 0.0, xc.LDA), ('0.25*HF + 0.75*B88, LYP', 0.25, xc.GGA),
    ('wb97x-v', 0.167, xc.GGA), ('camb3lyp', 0.19, xc.GGA),
    ('b97-1', 0.21, xc.GGA), ('pbe', 0.0, xc.GGA), ('pbe0', 0.25, xc.GGA),
    ('pbeh', 0.25, xc.GGA), ('pbe,pbe', 0.0, xc.GGA)])
def test_parse_matches_jax(name, hyb, family):
    got, ref = xc.parse_xc(name), jax_xc.parse_xc(name)
    assert got.hyb == ref.hyb == xc.hybrid_coeff(name) == hyb
    assert got.family == ref.family == family
    assert [c for c, _, _ in got.terms] == [c for c, _, _ in ref.terms]
    assert xc.rsh_coeff(name) == ref.rsh
    assert got.nlc == ref.nlc


@pytest.mark.parametrize('name', ['pz81', 'scan', 'b2plyp', 'tpss',
                                  'pw91', 'xalpha', 'b88,p86'])
def test_unported_functionals_raise(name):
    with pytest.raises(NotImplementedError, match='queue 1, remaining XC'):
        xc.parse_xc(name)


@pytest.mark.parametrize('name', ['pbe_x', 'pbe_c'])
def test_open_shell_pbe_matches_jax(name):
    """pbe_x and pbe_c of xc_funcs.py against the JAX package's at seeded
    spin-polarized points (rho_s, sigma_ss log-uniform, |sigma_ab| <=
    sqrt(sigma_aa sigma_bb) of either sign), value and the five first
    derivatives to 1e-12 of their size plus the point's energy-density
    scale rho_a^(4/3) + rho_b^(4/3) over the variable (sqrt(sigma_aa
    sigma_bb) for sigma_ab), as _scaled_gate."""
    from pyscf_tpu.dft import xc_funcs as jax_f
    from pyscf_tpu_torch.dft import xc_funcs as f
    rng = np.random.default_rng(31)
    n = 300
    ra, rb = 10.0 ** rng.uniform(-10, 2, (2, n))
    saa, sbb = 10.0 ** rng.uniform(-20, 3, (2, n))
    sab = rng.uniform(-1, 1, n) * np.sqrt(saa * sbb)
    x = [ra, rb, saa, sab, sbb]

    def port(a, b, xaa, xab, xbb):
        if name == 'pbe_x':
            return f.pbe_x(a, b, xaa, xbb)
        return f.pbe_c(a, b, xaa + 2 * xab + xbb)

    def ref(a, b, xaa, xab, xbb):
        if name == 'pbe_x':
            return jax_f.pbe_x(a, b, xaa, xbb)
        return jax_f.pbe_c(a, b, xaa + 2 * xab + xbb)

    t = [torch.as_tensor(v).requires_grad_() for v in x]
    e = port(*t)
    got = [e.detach().numpy()] + [
        np.zeros(n) if v is None else v.numpy()
        for v in torch.autograd.grad(e.sum(), t, allow_unused=True)]
    j = [jnp.asarray(v) for v in x]
    want = [np.asarray(ref(*j))] + [np.asarray(v) for v in jax.grad(
        lambda *a: jnp.sum(ref(*a)), argnums=(0, 1, 2, 3, 4))(*j)]
    scale = ra ** (4.0 / 3.0) + rb ** (4.0 / 3.0)
    for g, r, v in zip(got, want, [1.0, ra, rb, saa, np.sqrt(saa * sbb),
                                   sbb]):
        _scaled_gate(g, r, scale / v)

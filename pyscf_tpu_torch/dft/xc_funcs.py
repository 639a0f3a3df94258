"""Exchange-correlation energy densities in PyTorch: the B3LYP components.

Counterpart of pyscf_tpu/dft/xc_funcs.py for the components the ported
functionals use (Slater, VWN5, VWN3, B88, LYP), with the same formulas,
constants, operation order and clamps. Every function returns the energy
density per unit volume e(r), Exc = int e(r) d3r, of (rho_a, rho_b,
sigma_aa, sigma_ab, sigma_bb); spin-unpolarized callers pass
rho_a = rho_b = rho/2 and sigma_* = |grad rho|^2/4. Potentials come from
torch.autograd here (jax.grad in the JAX package); the CUDA kernel
`xc_rks` (csrc/xc_funcs.cuh) evaluates the same expressions on dual
numbers.
"""
import math

import torch

_TINY = 1e-30


def _max(x, lo):
    """jnp.maximum(x, lo): at a tie the gradient splits evenly, as in JAX."""
    return torch.maximum(x, x.new_tensor(lo))


def _clip(x, lo, hi):
    return torch.minimum(_max(x, lo), x.new_tensor(hi))


def _rs(rho):
    return (3.0 / (4.0 * math.pi * _max(rho, _TINY))) ** (1.0 / 3.0)


# ---------------------------------------------------------------------------
# LDA exchange
# ---------------------------------------------------------------------------

_CX = -(3.0 / 4.0) * (3.0 / math.pi) ** (1.0 / 3.0)


def lda_x(rho_a, rho_b):
    """Slater exchange, spin-scaled."""
    e = 0.0
    for r in (rho_a, rho_b):
        r2 = _max(2.0 * r, _TINY)
        e = e + 0.5 * _CX * r2 ** (4.0 / 3.0)
    return e


# ---------------------------------------------------------------------------
# VWN correlation (parametrization III/RPA and V)
# ---------------------------------------------------------------------------

def _vwn_eps(rs, A, x0, b, c):
    x = torch.sqrt(rs)
    X = x * x + b * x + c
    X0 = x0 * x0 + b * x0 + c
    Q = math.sqrt(4 * c - b * b)
    atanq = torch.atan(Q / (2 * x + b))
    return A * (torch.log(x * x / X) + 2 * b / Q * atanq
                - b * x0 / X0 * (torch.log((x - x0) ** 2 / X)
                                 + 2 * (b + 2 * x0) / Q * atanq))


# VWN5 parameters: paramagnetic, ferromagnetic, spin stiffness
_VWN5_P = (0.0310907, -0.10498, 3.72744, 12.9352)
_VWN5_F = (0.01554535, -0.32500, 7.06042, 18.0578)
_VWN5_A = (-1.0 / (6.0 * math.pi * math.pi), -0.00475840, 1.13107, 13.0045)

# VWN3 (RPA) parameters
_VWN3_P = (0.0310907, -0.409286, 13.0720, 42.7198)
_VWN3_F = (0.01554535, -0.743294, 20.1231, 101.578)


def _f_zeta(zeta):
    return (((1 + zeta) ** (4.0 / 3.0) + (1 - zeta) ** (4.0 / 3.0) - 2.0)
            / (2.0 ** (4.0 / 3.0) - 2.0))


def vwn5_c(rho_a, rho_b):
    rho = _max(rho_a + rho_b, _TINY)
    zeta = _clip((rho_a - rho_b) / rho, -1 + 1e-15, 1 - 1e-15)
    rs = _rs(rho)
    ep = _vwn_eps(rs, *_VWN5_P)
    ef = _vwn_eps(rs, *_VWN5_F)
    ea = _vwn_eps(rs, *_VWN5_A)
    f = _f_zeta(zeta)
    fpp0 = 4.0 / (9.0 * (2.0 ** (1.0 / 3.0) - 1.0))
    z4 = zeta ** 4
    eps = ep + ea * f / fpp0 * (1 - z4) + (ef - ep) * f * z4
    return rho * eps


def vwn3_c(rho_a, rho_b):
    """VWN III (RPA): the correlation used inside the original B3LYP."""
    rho = _max(rho_a + rho_b, _TINY)
    zeta = _clip((rho_a - rho_b) / rho, -1 + 1e-15, 1 - 1e-15)
    rs = _rs(rho)
    ep = _vwn_eps(rs, *_VWN3_P)
    ef = _vwn_eps(rs, *_VWN3_F)
    f = _f_zeta(zeta)
    eps = ep + (ef - ep) * f
    return rho * eps


# ---------------------------------------------------------------------------
# GGA exchange: B88
# ---------------------------------------------------------------------------

def b88_x(rho_a, rho_b, sigma_aa, sigma_bb):
    beta = 0.0042
    e = 0.0
    for r, s in ((rho_a, sigma_aa), (rho_b, sigma_bb)):
        r = _max(r, _TINY)
        r43 = r ** (4.0 / 3.0)
        x = torch.sqrt(_max(s, _TINY)) / r43
        lda = -(3.0 / 2.0) * (3.0 / (4 * math.pi)) ** (1.0 / 3.0) * r43
        corr = -beta * r43 * x * x / (1 + 6 * beta * x * torch.asinh(x))
        e = e + lda + corr
    return e


# ---------------------------------------------------------------------------
# LYP correlation (Miehlich et al. CPL 157, 200 form)
# ---------------------------------------------------------------------------

def lyp_c(rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb):
    a, b, c, d = 0.04918, 0.132, 0.2533, 0.349
    rho = _max(rho_a + rho_b, _TINY)
    rm3 = rho ** (-1.0 / 3.0)
    w = torch.exp(-c * rm3) / (1 + d * rm3) * rm3 ** 11
    dl = c * rm3 + d * rm3 / (1 + d * rm3)
    cf = 0.3 * (3.0 * math.pi ** 2) ** (2.0 / 3.0)
    gaa, gab, gbb = sigma_aa, sigma_ab, sigma_bb
    ra, rb = _max(rho_a, _TINY), _max(rho_b, _TINY)
    e = -a * (4.0 * ra * rb / (rho * (1 + d * rm3))
              + b * w * (
        ra * rb * (
            2 ** (11.0 / 3.0) * cf * (ra ** (8.0 / 3.0) + rb ** (8.0 / 3.0))
            + (47.0 / 18.0 - 7.0 / 18.0 * dl) * (gaa + 2 * gab + gbb)
            - (2.5 - dl / 18.0) * (gaa + gbb)
            - (dl - 11.0) / 9.0 * (ra / rho * gaa + rb / rho * gbb))
        - 2.0 / 3.0 * rho * rho * (gaa + 2 * gab + gbb)
        + (2.0 / 3.0 * rho * rho - ra * ra) * gbb
        + (2.0 / 3.0 * rho * rho - rb * rb) * gaa))
    return e

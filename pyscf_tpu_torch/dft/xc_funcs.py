"""Exchange-correlation energy densities in PyTorch.

Counterpart of pyscf_tpu/dft/xc_funcs.py for the components the ported
functionals use (Slater, VWN5, VWN3, B88, LYP, PBE exchange and
correlation; PW92 inside PBE and the B97 power-series family wb97_xc; the
CAM-attenuated B88 cam_b88_x), with the
same formulas, constants, operation order and clamps. Every function
returns the energy density per unit volume e(r), Exc = int e(r) d3r, of
(rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb); spin-unpolarized callers
pass rho_a = rho_b = rho/2 and sigma_* = |grad rho|^2/4. Potentials come
from torch.autograd here (jax.grad in the JAX package); the CUDA kernels
`xc_rks` and `xc_uks` (csrc/xc_funcs.cuh) evaluate the same expressions
on dual numbers.
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
# PW92 LDA correlation (inside the B97 family's Stoll partition)
# ---------------------------------------------------------------------------

def _pw92_g(rs, A, a1, b1, b2, b3, b4):
    s = torch.sqrt(rs)
    den = 2.0 * A * (b1 * s + b2 * rs + b3 * rs * s + b4 * rs * rs)
    return -2.0 * A * (1 + a1 * rs) * torch.log1p(1.0 / _max(den, _TINY))


def pw92_eps(rho_a, rho_b):
    rho = _max(rho_a + rho_b, _TINY)
    zeta = _clip((rho_a - rho_b) / rho, -1 + 1e-15, 1 - 1e-15)
    rs = _rs(rho)
    e0 = _pw92_g(rs, 0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294)
    e1 = _pw92_g(rs, 0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517)
    alc = -_pw92_g(rs, 0.016887, 0.11125, 10.357, 3.6231, 0.88026, 0.49671)
    f = _f_zeta(zeta)
    fpp0 = 1.709920934161365617563962776245
    z4 = zeta ** 4
    return e0 + alc * f / fpp0 * (1 - z4) + (e1 - e0) * f * z4


# ---------------------------------------------------------------------------
# GGA exchange: B88, PBE
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


def pbe_x(rho_a, rho_b, sigma_aa, sigma_bb):
    """PBE exchange (Perdew, Burke, Ernzerhof, PRL 77, 3865), spin-scaled:
    each spin's term is half the unpolarized one at 2 rho_s, 4 sigma_ss."""
    kappa, mu = 0.8040, 0.2195149727645171
    e = 0.0
    for r, s in ((rho_a, sigma_aa), (rho_b, sigma_bb)):
        r2 = _max(2.0 * r, _TINY)
        s2 = 4.0 * _max(s, 0.0)
        kf = (3.0 * math.pi ** 2 * r2) ** (1.0 / 3.0)
        # s^2 without a square root, so that sigma = 0 differentiates
        ss2 = s2 / (2.0 * kf * r2) ** 2
        fx = 1 + kappa - kappa / (1 + mu * ss2 / kappa)
        ex_lda = _CX * r2 ** (4.0 / 3.0)
        e = e + 0.5 * ex_lda * fx
    return e


def pbe_c(rho_a, rho_b, sigma):
    """PBE correlation on PW92, sigma = |grad rho_total|^2 = sigma_aa + 2
    sigma_ab + sigma_bb."""
    rho = _max(rho_a + rho_b, _TINY)
    zeta = _clip((rho_a - rho_b) / rho, -1 + 1e-15, 1 - 1e-15)
    eps = pw92_eps(rho_a, rho_b)
    beta, gamma = 0.06672455060314922, (1 - math.log(2.0)) / math.pi ** 2
    phi = 0.5 * ((1 + zeta) ** (2.0 / 3.0) + (1 - zeta) ** (2.0 / 3.0))
    kf = (3.0 * math.pi ** 2 * rho) ** (1.0 / 3.0)
    ks = torch.sqrt(4.0 * kf / math.pi)
    t2 = _max(sigma, 0.0) / (2.0 * phi * ks * rho) ** 2
    # A = (beta/gamma) / (exp(-eps/(gamma phi^3)) - 1), by expm1
    A = beta / gamma / _max(torch.expm1(-eps / (gamma * phi ** 3)), _TINY)
    u = A * t2
    H = gamma * phi ** 3 * torch.log1p(
        beta / gamma * t2 * (1.0 + u) / (1.0 + u + u * u))
    return rho * (eps + H)


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


# ---------------------------------------------------------------------------
# Range-separated (erf) attenuated exchange: the ITYH scheme (Iikura,
# Tsuneda, Yanai, Hirao, JCP 115, 3540 (2001))
# ---------------------------------------------------------------------------

def _sr_attenuation(a):
    """F(a): the fraction of exchange that survives erfc(w r)/r attenuation,
    a = w / (2 k_sigma), on a clipped to [1e-10, 50]. At large a the bracket
    is a difference of terms near 1e8 that leaves ~1e-5: the result carries
    ~1e-3 relative rounding there, as in the JAX package."""
    a = _clip(a, 1e-10, 50.0)
    a2 = a * a
    # exp(-1/(4a^2)) underflows for small a: the exponent is clamped
    expf = torch.exp(-torch.minimum(1.0 / (4.0 * a2), a2.new_tensor(700.0)))
    erfv = torch.special.erf(1.0 / (2.0 * a))
    return 1.0 - (8.0 / 3.0) * a * (
        math.sqrt(math.pi) * erfv - 3.0 * a + 4.0 * a ** 3
        + (2.0 * a - 4.0 * a ** 3) * expf)


def cam_b88_x(rho_a, rho_b, sigma_aa, sigma_bb, omega, alpha, beta):
    """B88 exchange with the CAM partition of 1/r12: the DFT part keeps
    [1 - alpha - beta + beta F(a_sigma)] of the full B88 energy density,
    a_sigma = omega / (2 k_sigma), k_sigma = (9 pi / K_sigma)^(1/2)
    rho_sigma^(1/3); alpha and beta are the CAM HF fractions."""
    bbeta = 0.0042
    e = 0.0
    for r, s in ((rho_a, sigma_aa), (rho_b, sigma_bb)):
        r_ = _max(r, _TINY)
        r43 = r_ ** (4.0 / 3.0)
        x = torch.sqrt(_max(s, _TINY)) / r43
        lda = -(3.0 / 2.0) * (3.0 / (4 * math.pi)) ** (1.0 / 3.0) * r43
        corr = -bbeta * r43 * x * x / (1 + 6 * bbeta * x * torch.asinh(x))
        e_full = lda + corr                     # = -(1/2) r^(4/3) K
        K = _max(-2.0 * e_full / r43, _TINY)
        k_sig = torch.sqrt(9.0 * math.pi / K) * r_ ** (1.0 / 3.0)
        a = omega / (2.0 * k_sig)
        F = _sr_attenuation(a)
        e = e + e_full * (1.0 - alpha - beta + beta * F)
    return e


# ---------------------------------------------------------------------------
# B97-type power-series functionals with range separation: the omega-B97
# family (Chai & Head-Gordon, JCP 128, 084106 (2008); omega-B97X-V:
# Mardirossian & Head-Gordon, PCCP 16, 9904 (2014)). Exchange: per-spin
# short-range LDA exchange (attenuation F(a), a = omega/(2 kF_sigma),
# kF_sigma = (6 pi^2 n_sigma)^(1/3)) times g(u) = sum_i c_i u^i,
# u = gamma s^2/(1 + gamma s^2), s^2 = sigma_ss / n_sigma^(8/3).
# Correlation: the Stoll same/opposite-spin partition of PW92, each part
# times its own series.
# ---------------------------------------------------------------------------

def _b97_u(s2, gamma):
    gs = gamma * s2
    return gs / (1.0 + gs)


def _b97_series(u, coeffs):
    acc = 0.0
    for c in reversed(coeffs):
        acc = acc * u + c
    return acc


def wb97_xc(rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb, omega, cx, css,
            cos_):
    """The omega-B97 family's semilocal part: short-range GGA exchange and
    B97 correlation (full range); cx, css and cos_ are the series
    coefficients of exchange, same-spin and opposite-spin correlation."""
    gam_x, gam_ss, gam_os = 0.004, 0.2, 0.006
    e = 0.0
    s2s = []
    for r, s in ((rho_a, sigma_aa), (rho_b, sigma_bb)):
        r_ = _max(r, _TINY)
        s_ = _max(s, 0.0)
        s2 = s_ / r_ ** (8.0 / 3.0)
        s2s.append(s2)
        # short-range LDA exchange of this spin: attenuated Slater
        e_lda = -1.5 * (3.0 / (4.0 * math.pi)) ** (1.0 / 3.0) \
            * r_ ** (4.0 / 3.0)
        kf = (6.0 * math.pi ** 2 * r_) ** (1.0 / 3.0)
        Fa = _sr_attenuation(omega / (2.0 * kf))
        gx = _b97_series(_b97_u(s2, gam_x), cx)
        e = e + e_lda * Fa * gx
    # Stoll partition of PW92 correlation
    z = torch.zeros_like(rho_a) + _TINY
    ec_ab = (rho_a + rho_b) * pw92_eps(rho_a, rho_b)
    ec_aa = rho_a * pw92_eps(rho_a, z)
    ec_bb = rho_b * pw92_eps(z, rho_b)
    g_ss_a = _b97_series(_b97_u(s2s[0], gam_ss), css)
    g_ss_b = _b97_series(_b97_u(s2s[1], gam_ss), css)
    u_os = _b97_u(0.5 * (s2s[0] + s2s[1]), gam_os)
    g_os = _b97_series(u_os, cos_)
    e = e + ec_aa * g_ss_a + ec_bb * g_ss_b + (ec_ab - ec_aa - ec_bb) * g_os
    return e


# published parameter sets: name -> (omega, SR_HF, LR_HF, cx, css, cos, nlc)
WB97_PARAMS = {
    # Mardirossian & Head-Gordon PCCP 16, 9904 (2014), Table 3
    'WB97X_V': (0.3, 0.167, 1.0,
                (0.833, 0.603),
                (0.556, -0.257),
                (1.219, -1.850),
                ('VV10', 6.0, 0.01)),
    # Chai & Head-Gordon JCP 128, 084106 (2008), Table 1
    'WB97': (0.4, 0.0, 1.0,
             (1.0, 1.13116, -2.74915, 12.09000, -5.71642),
             (1.0, -2.55352, 11.8926, -26.9452, 17.0927),
             (1.0, 3.99051, -17.0066, 1.07292, 8.88211),
             None),
    'WB97X': (0.3, 0.157706, 1.0,
              (0.842294, 0.726069, 1.04451, -5.70635, 13.2794),
              (1.0, -4.33879, 18.2308, -31.7430, 17.2901),
              (1.0, 2.37031, -11.3995, 6.58405, -3.78132),
              None),
}

# published B97-family full-range parameter sets (omega = 0):
# name -> (hyb, cx, css, cos)
B97_PARAMS = {
    # Becke JCP 107, 8554 (1997), Table I
    'B97': (0.1943,
            (0.8094, 0.5073, 0.7481),
            (0.1737, 2.3487, -2.4868),
            (0.9454, 0.7471, -4.5961)),
    # Hamprecht, Cohen, Tozer, Handy JCP 109, 6264 (1998), Table II
    'B97_1': (0.21,
              (0.789518, 0.573805, 0.660975),
              (0.0820011, 2.71681, -2.87103),
              (0.955689, 0.788552, -5.47869)),
    # Wilson, Bradley, Tozer JCP 115, 9233 (2001), Table 1
    'B97_2': (0.21,
              (0.827642, 0.04784, 1.76125),
              (0.585808, -0.691682, 0.394796),
              (0.999849, 1.40626, -7.44060)),
    # Grimme J. Comput. Chem. 27, 1787 (2006) (used with DFT-D2)
    'B97_D': (0.0,
              (1.08662, -0.52127, 3.25429),
              (0.22340, -1.56208, 1.94293),
              (0.69041, 6.30270, -14.9712)),
}

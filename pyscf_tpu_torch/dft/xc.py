"""XC functional composition: parse_xc and XCFunctional.

Counterpart of pyscf_tpu/dft/xc.py for the functionals built from the
ported components (Slater, VWN5, VWN3, B88, LYP, PBE exchange and
correlation, the CAM-attenuated B88 and the B97 power series): the names
SLATER/LDA, VWN/VWN5, VWN3/VWN_RPA, B88/B, LYP, PBE_X and PBE_C, the
compounds LDA, LDA,VWN, SVWN, BLYP, B3LYP, B3LYP5, B3LYPG, PBE, PBE0 and
PBEH, the range-separated hybrids WB97, WB97X, WB97X-V (with VV10
non-local correlation) and CAMB3LYP/CAM_B3LYP, the full-range B97 hybrids
B97, B97-1, B97-2 and B97-D (alias B97D), and the 'X,C' and 'a*X + b*Y'
forms with HF for exact exchange, where a name of the exchange part may
drop its _X and one of the correlation part its _C ('pbe,pbe'). Any other
name (meta-GGA, PW91, P86, double hybrids and the rest) raises
NotImplementedError: those are ROADMAP.md queue 1.

A functional is a list of weighted components plus a hybrid HF-exchange
fraction; the energy density is their weighted sum, in the order listed.
A component that takes parameters (omega, the series coefficients, the CAM
fractions) gets them from `params`, one tuple per term, so that the XC
kernels receive them as data.
"""
from functools import lru_cache

from . import xc_funcs as F

# component kinds
LDA, GGA, MGGA = 0, 1, 2


def _x_slater(ra, rb, saa, sab, sbb):
    return F.lda_x(ra, rb)


def _c_vwn5(ra, rb, saa, sab, sbb):
    return F.vwn5_c(ra, rb)


def _c_vwn3(ra, rb, saa, sab, sbb):
    return F.vwn3_c(ra, rb)


def _x_b88(ra, rb, saa, sab, sbb):
    return F.b88_x(ra, rb, saa, sbb)


def _c_lyp(ra, rb, saa, sab, sbb):
    return F.lyp_c(ra, rb, saa, sab, sbb)


def _x_pbe(ra, rb, saa, sab, sbb):
    return F.pbe_x(ra, rb, saa, sbb)


def _c_pbe(ra, rb, saa, sab, sbb):
    return F.pbe_c(ra, rb, saa + 2 * sab + sbb)


def _x_cam_b88(ra, rb, saa, sab, sbb, omega, alpha, beta):
    return F.cam_b88_x(ra, rb, saa, sbb, omega, alpha, beta)


def _xc_wb97(ra, rb, saa, sab, sbb, omega, cx, css, cos_):
    return F.wb97_xc(ra, rb, saa, sab, sbb, omega, cx, css, cos_)


# component -> (family, fn(ra, rb, saa, sab, sbb, *params)); the kernels
# `xc_rks` and `xc_uks` know them by these names
COMPONENTS = {
    'SLATER': (LDA, _x_slater),
    'VWN5': (LDA, _c_vwn5),
    'VWN3': (LDA, _c_vwn3),
    'B88': (GGA, _x_b88),
    'LYP': (GGA, _c_lyp),
    'PBE_X': (GGA, _x_pbe),
    'PBE_C': (GGA, _c_pbe),
    'CAM_B88': (GGA, _x_cam_b88),
    'WB97': (GGA, _xc_wb97),
}

# name -> component
FUNCTIONALS = {
    'SLATER': 'SLATER',
    'LDA': 'SLATER',
    'VWN': 'VWN5',
    'VWN5': 'VWN5',
    'VWN3': 'VWN3',
    'VWN_RPA': 'VWN3',
    'B88': 'B88',
    'B': 'B88',
    'LYP': 'LYP',
    'PBE_X': 'PBE_X',
    'PBE_C': 'PBE_C',
}

# compound aliases: (hyb, [(coeff, xname)], [(coeff, cname)])
COMPOUND = {
    'LDA,VWN': (0.0, [(1.0, 'SLATER')], [(1.0, 'VWN5')]),
    'LDA': (0.0, [(1.0, 'SLATER')], []),
    'SVWN': (0.0, [(1.0, 'SLATER')], [(1.0, 'VWN5')]),
    'PBE': (0.0, [(1.0, 'PBE_X')], [(1.0, 'PBE_C')]),
    'PBE0': (0.25, [(0.75, 'PBE_X')], [(1.0, 'PBE_C')]),
    'PBEH': (0.25, [(0.75, 'PBE_X')], [(1.0, 'PBE_C')]),
    'BLYP': (0.0, [(1.0, 'B88')], [(1.0, 'LYP')]),
    'B3LYP': (0.2, [(0.08, 'SLATER'), (0.72, 'B88')],
              [(0.81, 'LYP'), (0.19, 'VWN_RPA')]),
    'B3LYP5': (0.2, [(0.08, 'SLATER'), (0.72, 'B88')],
               [(0.81, 'LYP'), (0.19, 'VWN5')]),
    'B3LYPG': (0.2, [(0.08, 'SLATER'), (0.72, 'B88')],
               [(0.81, 'LYP'), (0.19, 'VWN_RPA')]),
}


# range-separated compounds: name -> (omega, alpha (the short-range HF
# fraction), beta (the long-range increment), [(coeff, cname)]); exchange
# is CAM_B88 with (omega, alpha, beta)
RSH_COMPOUND = {
    'CAMB3LYP': (0.33, 0.19, 0.46, [(0.81, 'LYP'), (0.19, 'VWN5')]),
    'CAM_B3LYP': (0.33, 0.19, 0.46, [(0.81, 'LYP'), (0.19, 'VWN5')]),
}


class XCFunctional:
    def __init__(self, hyb, terms, params=None, rsh=(0.0, 0.0, 0.0),
                 nlc=None):
        self.hyb = hyb               # HF exchange fraction (the SR part)
        self.terms = terms           # [(coeff, family, component)]
        # one tuple of parameters per term, () for a plain component
        self.params = params or [()] * len(terms)
        self.family = max((f for _, f, _ in terms), default=LDA)
        # range separation (omega, alpha_LR_total, hyb_SR):
        # K = hyb K + (alpha - hyb) K_LR
        self.rsh = rsh
        self.omega = rsh[0]
        # built-in non-local correlation: ('VV10', b, C) or None
        self.nlc = nlc

    def exc_density(self, ra, rb, saa, sab, sbb):
        e = 0.0
        for (c, _, comp), p in zip(self.terms, self.params):
            e = e + c * COMPONENTS[comp][1](ra, rb, saa, sab, sbb, *p)
        return e

    @property
    def is_gga(self):
        return self.family >= GGA

    @property
    def is_mgga(self):
        return self.family >= MGGA


def _not_ported(name, xc_code):
    return NotImplementedError(
        f'XC functional {name!r} in {xc_code!r} is not ported to '
        'pyscf_tpu_torch (ROADMAP.md queue 1, remaining XC); the ported '
        f'names are {sorted(FUNCTIONALS)}, the compounds '
        f'{sorted(COMPOUND)}, {sorted(RSH_COMPOUND)}, '
        f'{sorted(F.WB97_PARAMS)} and {sorted(F.B97_PARAMS)} (B97D)')


def _term(c, name, xc_code, kind=None):
    """(c, family, component) of a name; in the 'X,C' form a name of the
    exchange (kind 'X') or correlation part ('C') may drop its suffix, as
    pyscf_tpu/dft/xc.py parse_xc reads 'pbe,pbe'."""
    if name not in FUNCTIONALS and f'{name}_{kind}' in FUNCTIONALS:
        name = f'{name}_{kind}'
    if name not in FUNCTIONALS:
        raise _not_ported(name, xc_code)
    comp = FUNCTIONALS[name]
    return (c, COMPONENTS[comp][0], comp)


def _parse_terms(spec):
    """Parse 'A + 0.5*B' style sums into [(coeff, NAME)]."""
    out = []
    for tok in spec.replace('-', '_MINUS_').split('+'):
        tok = tok.strip().replace('_MINUS_', '-')
        if not tok:
            continue
        coeff = 1.0
        name = tok
        if '*' in tok:
            c, name = tok.split('*')
            coeff = float(c)
        out.append((coeff, name.strip().upper()))
    return out


@lru_cache(maxsize=None)
def parse_xc(xc_code):
    """Parse an XC specification string into an XCFunctional."""
    if not isinstance(xc_code, str):
        raise TypeError(xc_code)
    code = xc_code.upper().replace(' ', '')
    cname = code.replace('-', '_')      # compound-name lookups only
    if cname in F.WB97_PARAMS:
        omega, sr_hf, lr_hf, cx, css, cos_, nlc = F.WB97_PARAMS[cname]
        return XCFunctional(sr_hf, [(1.0, GGA, 'WB97')],
                            [(omega, cx, css, cos_)],
                            rsh=(omega, lr_hf, sr_hf), nlc=nlc)
    if cname == 'B97D':
        cname = 'B97_D'
    if cname in F.B97_PARAMS:
        # full-range B97 hybrids: the same series with omega = 0
        hyb, cx, css, cos_ = F.B97_PARAMS[cname]
        return XCFunctional(hyb, [(1.0, GGA, 'WB97')], [(0.0, cx, css, cos_)])
    if cname in RSH_COMPOUND:
        omega, a, b, cs = RSH_COMPOUND[cname]
        terms = [(1.0, GGA, 'CAM_B88')] + [_term(c, n, xc_code)
                                           for c, n in cs]
        return XCFunctional(a, terms, [(omega, a, b)] + [()] * len(cs),
                            rsh=(omega, a + b, a))
    if code in COMPOUND:
        hyb, xs, cs = COMPOUND[code]
        return XCFunctional(hyb, [_term(c, n, xc_code) for c, n in xs + cs])
    hyb = 0.0
    terms = []
    parts = code.split(',', 1)          # exchange, then correlation
    for spec, kind in zip(parts, 'XC'):
        for coeff, name in _parse_terms(spec):
            if name == 'HF':
                hyb += coeff
            else:
                terms.append(_term(coeff, name, xc_code, kind))
    if not terms:                       # exact exchange alone, as 'HF,'
        raise _not_ported(xc_code, xc_code)
    return XCFunctional(hyb, terms)


def hybrid_coeff(xc_code):
    return parse_xc(xc_code).hyb


def rsh_coeff(xc_code):
    """(omega, alpha_LR, hyb_SR) in the JAX package's convention."""
    return parse_xc(xc_code).rsh

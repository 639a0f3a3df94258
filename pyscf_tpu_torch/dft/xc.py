"""XC functional composition: parse_xc and XCFunctional.

Counterpart of pyscf_tpu/dft/xc.py for the functionals built from the
ported components (Slater, VWN5, VWN3, B88, LYP): the names SLATER/LDA,
VWN/VWN5, VWN3/VWN_RPA, B88/B and LYP, the compounds LDA, LDA,VWN, SVWN,
BLYP, B3LYP, B3LYP5 and B3LYPG, and the 'X,C' and 'a*X + b*Y' forms with
HF for exact exchange. Any other name (meta-GGA, range-separated, double
hybrid, VV10 and the rest) raises NotImplementedError: those are ROADMAP.md
queue 1 step 9.

A functional is a list of weighted components plus a hybrid HF-exchange
fraction; the energy density is their weighted sum, in the order listed.
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


# component -> (family, fn); the kernel `xc_rks` knows them by these names
COMPONENTS = {
    'SLATER': (LDA, _x_slater),
    'VWN5': (LDA, _c_vwn5),
    'VWN3': (LDA, _c_vwn3),
    'B88': (GGA, _x_b88),
    'LYP': (GGA, _c_lyp),
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
}

# compound aliases: (hyb, [(coeff, xname)], [(coeff, cname)])
COMPOUND = {
    'LDA,VWN': (0.0, [(1.0, 'SLATER')], [(1.0, 'VWN5')]),
    'LDA': (0.0, [(1.0, 'SLATER')], []),
    'SVWN': (0.0, [(1.0, 'SLATER')], [(1.0, 'VWN5')]),
    'BLYP': (0.0, [(1.0, 'B88')], [(1.0, 'LYP')]),
    'B3LYP': (0.2, [(0.08, 'SLATER'), (0.72, 'B88')],
              [(0.81, 'LYP'), (0.19, 'VWN_RPA')]),
    'B3LYP5': (0.2, [(0.08, 'SLATER'), (0.72, 'B88')],
               [(0.81, 'LYP'), (0.19, 'VWN5')]),
    'B3LYPG': (0.2, [(0.08, 'SLATER'), (0.72, 'B88')],
               [(0.81, 'LYP'), (0.19, 'VWN_RPA')]),
}


class XCFunctional:
    def __init__(self, hyb, terms):
        self.hyb = hyb               # HF exchange fraction
        self.terms = terms           # [(coeff, family, component)]
        self.family = max((f for _, f, _ in terms), default=LDA)
        self.rsh = (0.0, 0.0, 0.0)   # no range-separated functional ported

    def exc_density(self, ra, rb, saa, sab, sbb):
        e = 0.0
        for c, _, comp in self.terms:
            e = e + c * COMPONENTS[comp][1](ra, rb, saa, sab, sbb)
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
        'pyscf_tpu_torch (ROADMAP.md queue 1 step 9); the ported names are '
        f'{sorted(FUNCTIONALS)} and the compounds {sorted(COMPOUND)}')


def _term(c, name, xc_code):
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
    if code in COMPOUND:
        hyb, xs, cs = COMPOUND[code]
        return XCFunctional(hyb, [_term(c, n, xc_code) for c, n in xs + cs])
    hyb = 0.0
    terms = []
    parts = code.split(',', 1)          # exchange, then correlation
    for spec in parts:
        for coeff, name in _parse_terms(spec):
            if name == 'HF':
                hyb += coeff
            else:
                terms.append(_term(coeff, name, xc_code))
    if not terms:                       # exact exchange alone, as 'HF,'
        raise _not_ported(xc_code, xc_code)
    return XCFunctional(hyb, terms)


def hybrid_coeff(xc_code):
    return parse_xc(xc_code).hyb


def rsh_coeff(xc_code):
    """(omega, alpha_LR, hyb_SR) in the JAX package's convention."""
    return parse_xc(xc_code).rsh

"""Auxiliary basis selection rules (copied from pyscf_tpu/df/addons.py).

make_auxbasis maps an orbital basis name onto a fitting basis; defaults to
the def2-universal JK-fitting set (Weigend) when no tailored set exists.
"""
from ..gto import basis as basis_mod

# orbital-basis -> jkfit auxiliary basis (normalized names)
JKFIT_MAP = {
    'ccpvdz': 'cc-pvdz-jkfit',
    'ccpvtz': 'cc-pvtz-jkfit',
    'ccpvqz': 'cc-pvqz-jkfit',
    'ccpv5z': 'cc-pv5z-jkfit',
    'augccpvdz': 'aug-cc-pvdz-jkfit',
    'augccpvtz': 'aug-cc-pvtz-jkfit',
    'augccpvqz': 'aug-cc-pvqz-jkfit',
    'def2svp': 'def2-universal-jkfit',
    'def2svpd': 'def2-universal-jkfit',
    'def2tzvp': 'def2-universal-jkfit',
    'def2tzvpp': 'def2-universal-jkfit',
    'def2tzvppd': 'def2-universal-jkfit',
    'def2qzvp': 'def2-universal-jkfit',
    'def2qzvpp': 'def2-universal-jkfit',
}

MP2FIT_MAP = {
    'ccpvdz': 'cc-pvdz-ri',
    'ccpvtz': 'cc-pvtz-ri',
    'ccpvqz': 'cc-pvqz-ri',
    'ccpv5z': 'cc-pv5z-ri',
    'augccpvdz': 'aug-cc-pvdz-ri',
    'augccpvtz': 'aug-cc-pvtz-ri',
    'augccpvqz': 'aug-cc-pvqz-ri',
    'def2svp': 'def2-svp-ri',
    'def2tzvp': 'def2-tzvp-ri',
    'def2tzvpp': 'def2-tzvpp-ri',
}


def make_auxbasis(mol, mp2fit=False):
    """Pick a fitting basis for mol's orbital basis."""
    if isinstance(mol.basis, str):
        norm = basis_mod.normalize_name(mol.basis)
        table = MP2FIT_MAP if mp2fit else JKFIT_MAP
        if norm in table:
            return table[norm]
    return 'def2-universal-jkfit'


def make_auxmol(mol, auxbasis=None):
    """Build a Mole carrying the auxiliary basis on the same geometry and
    device."""
    from ..gto.mole import Mole
    if auxbasis is None:
        auxbasis = make_auxbasis(mol)
    if auxbasis == 'autoaux':
        raise NotImplementedError('autoaux fitting sets are not ported')
    auxmol = Mole(atom=list(zip(mol.raw_symbols, mol.coords)),
                  basis=auxbasis, unit='bohr', charge=mol.charge,
                  spin=mol.spin, verbose=0, device=mol.device)
    auxmol.build()
    return auxmol

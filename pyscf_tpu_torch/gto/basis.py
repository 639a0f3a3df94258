"""Basis-set loading from the JAX package's JSON.gz tables.

Counterpart of pyscf_tpu/gto/basis.py (load, normalize_name). The tables
are read by path from pyscf_tpu/gto/basis_data/ next to this package, not
copied and not imported (importing pyscf_tpu would import jax).
"""
import gzip
import json
import os
from functools import lru_cache

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))),
    'pyscf_tpu', 'gto', 'basis_data')

# common alternate spellings -> normalized file stem
ALIAS = {
    'weigend': 'def2universaljkfit',
    'weigend+etb': 'def2universaljkfit',
    'def2universaljfit': 'def2universaljfit',
    'sto3g': 'sto3g',
    'minao': 'minao',
    'ccpvdz': 'ccpvdz',
}


def normalize_name(name):
    return (name.lower().replace('-', '').replace('_', '').replace(' ', '')
            .replace('*', 's'))


@lru_cache(maxsize=None)
def _load_file(stem):
    if not os.path.isdir(_DATA_DIR):
        raise FileNotFoundError(
            f'basis data directory {_DATA_DIR} is missing: pyscf_tpu_torch '
            'reads the basis tables of the pyscf_tpu package beside it')
    path = os.path.join(_DATA_DIR, stem + '.json.gz')
    if not os.path.exists(path):
        raise KeyError(f'Unknown basis set: {stem!r} (no file {path})')
    with gzip.open(path, 'rt') as f:
        return json.load(f)


def load(basis_name, symbol):
    """Return basis for one element: [[l, [exp, c1, ...], ...], ...]."""
    stem = normalize_name(basis_name)
    stem = ALIAS.get(stem, stem)
    data = _load_file(stem)
    if symbol not in data:
        raise KeyError(f'Element {symbol} not in basis {basis_name}')
    return [[s[0]] + [list(row) for row in s[1:]] for s in data[symbol]]

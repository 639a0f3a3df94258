from .cell import Cell, M, load_pseudo  # noqa: F401

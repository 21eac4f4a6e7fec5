"""Inner solver: batched stochastic L-BFGS with Armijo search."""

from .compact import compact_direction, compact_solves
from .lbfgs import LBFGSAux, LBFGSConfig, LBFGSState, lbfgs_init, lbfgs_step
from .linesearch import backtracking_armijo_aux

__all__ = [
    "LBFGSAux",
    "LBFGSConfig",
    "LBFGSState",
    "backtracking_armijo_aux",
    "compact_direction",
    "compact_solves",
    "lbfgs_init",
    "lbfgs_step",
]

"""Inner solver: batched stochastic L-BFGS with Armijo, cubic or fixed steps."""

from .compact import compact_direction, compact_solves
from .lbfgs import LBFGSAux, LBFGSConfig, LBFGSState, clone_state, lbfgs_init, lbfgs_step
from .linesearch import backtracking_armijo_aux, backtracking_armijo_probes_aux, cubic_linesearch

__all__ = [
    "LBFGSAux",
    "LBFGSConfig",
    "LBFGSState",
    "backtracking_armijo_aux",
    "backtracking_armijo_probes_aux",
    "clone_state",
    "compact_direction",
    "compact_solves",
    "cubic_linesearch",
    "lbfgs_init",
    "lbfgs_step",
]

"""Vol-surface engine: smile fits + maturity interpolation + no-arbitrage
diagnostics. The flagship model of the framework (BASELINE.json configs
#1, #2, #3)."""

from iv_engine.surface.surface import (  # noqa: F401
    SurfaceFit,
    eval_surface,
    fit_surface,
    fit_eval_surface,
)
from iv_engine.surface.arbitrage import (  # noqa: F401
    butterfly_g,
    calendar_violations,
    check_surface_arbitrage,
)
from iv_engine.surface.localvol import (  # noqa: F401
    local_variance_grid,
    local_vol_surface,
    risk_neutral_density,
    variance_swap_strike,
)

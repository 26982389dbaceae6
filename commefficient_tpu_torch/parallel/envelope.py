"""The fitted d/c stability envelope of sketch-mode error feedback (the
port's own copy of the reference's ``parallel/envelope.py``).

Each round the virtual error bank receives the unextracted gradient mass,
sheds the fraction ``phi`` that the top-k extraction recovers, and is
scaled by ``gamma = error_decay``, so its steady-state norm is ``G / (1 -
gamma * (1 - phi))``. CountSketch estimate noise per coordinate scales as
that norm over ``sqrt(c)``, so extraction keeps working while

    d/c  <  rho_star(gamma) = rho1 * ((1 - gamma * (1 - phi)) / phi)**2

The two constants are the reference's fit to its quarter-scale sweep
(``rho1 = 27``, ``phi = 0.26``: cliffs at d/c 27, 35.2 and 44.6 for gamma
1, 0.95 and 0.9), held out at gamma 0.925 and 0.85. The port keeps the
numbers as they are: they describe the algorithm, not the hardware.
"""

from __future__ import annotations

RHO1 = 27.0  # the gamma = 1 cliff (d/c)
PHI = 0.26  # the per-round extraction fraction of the error bank
# warn above the last point measured fully stable (25), not at the fitted
# cliff (27)
SAFETY = 25.0 / 27.0
# the gamma range the model was fitted and validated on; below it the
# bound is held at this gamma's value instead of extrapolated
GAMMA_FIT_MIN = 0.85


def predicted_dc_max(error_decay: float, *, rho1: float = RHO1,
                     phi: float = PHI) -> float:
    """The fitted largest stable realized d/c for ``error_decay``:
    ``rho1 * ((1 - gamma * (1 - phi)) / phi)**2`` (1.0 -> 27.00, 0.95 ->
    35.23, 0.9 -> 44.56, 0.85 -> 54.97)."""
    g = float(error_decay)
    return rho1 * ((1.0 - g * (1.0 - phi)) / phi) ** 2


def stable_dc_bound(error_decay: float) -> float:
    """The bound the session warns above: the fitted cliff scaled back to
    the last measured-stable point, with gamma clamped to the fitted
    range."""
    g = max(float(error_decay), GAMMA_FIT_MIN)
    return SAFETY * predicted_dc_max(g)

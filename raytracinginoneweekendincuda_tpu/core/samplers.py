"""Branchless random-point samplers.

The CUDA reference draws points in the unit ball / unit disk by *rejection*
(`Material.h:14-24`, `Camera.h:10-19`): loop until a cube/square sample lands
inside.  Data-dependent loop trip counts are hostile to a vector machine —
every lane would wait for the unluckiest lane — so this build uses exact
*analytic* inversions instead.  These produce the identical distributions
(uniform in ball / disk) from a fixed number of uniforms, which also keeps
the counter-RNG draw budget static.

The f64 oracle uses the same samplers, so engine-vs-oracle comparisons are
sample-path exact; parity with the reference is distributional ("allclose",
not bit-equal — per BASELINE.json), which is the only feasible contract
across different RNGs anyway.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

TWO_PI = 2.0 * math.pi


def _safe_root(x, p, xp):
    """x**p with a finite derivative at x == 0 (forward-identical: the
    guarded branch returns exactly 0).  Roots have infinite slope at 0, and
    a zero uniform draw (prob 2^-24 each) would turn ANY masked-out or
    zero-weighted cotangent into 0 x inf = NaN in reverse mode."""
    pos = x > 0
    return xp.where(pos, xp.where(pos, x, 1.0) ** p, 0.0)


def unit_ball(u1, u2, u3, xp=jnp):
    """Uniform point in the unit ball from three uniforms in [0, 1).

    Direction: z uniform in [-1, 1), azimuth uniform — exactly uniform on the
    sphere.  Radius: cube-root inversion of the CDF r^3.
    Replaces the rejection loop at Material.h:14-24.
    """
    z = 1.0 - 2.0 * u1
    phi = TWO_PI * u2
    rho = _safe_root(1.0 - z * z, 0.5, xp)
    r = _safe_root(u3, 1.0 / 3.0, xp)
    return xp.stack((r * rho * xp.cos(phi), r * rho * xp.sin(phi), r * z), axis=-1)


def unit_sphere_surface(u1, u2, xp=jnp):
    """Uniform direction on the unit sphere (Isotropic phase function,
    Material.h:160 — ``UnitVector(RandomInUnitSphere(...))``)."""
    z = 1.0 - 2.0 * u1
    phi = TWO_PI * u2
    rho = _safe_root(1.0 - z * z, 0.5, xp)
    return xp.stack((rho * xp.cos(phi), rho * xp.sin(phi), z), axis=-1)


def unit_disk(u1, u2, xp=jnp):
    """Uniform point in the unit disk (z=0) from two uniforms.

    sqrt-radius inversion; replaces the rejection loop at Camera.h:10-19
    (defocus-blur lens sampling).
    """
    r = _safe_root(u1, 0.5, xp)
    theta = TWO_PI * u2
    return xp.stack((r * xp.cos(theta), r * xp.sin(theta)), axis=-1)

"""3-vector math on ``(..., 3)`` arrays.

The CUDA reference's ``Vector3`` (Vec3.h:10-141) is a scalar struct of three
doubles with free functions ``Dot/Cross/UnitVector/Reflect/Refract``.  Under
XLA the natural layout is batched arrays with a trailing axis of 3; every helper
here is shape-polymorphic over leading batch dimensions.

Written against generic array operators only, so the same functions serve
``numpy`` (f64 oracle) and ``jax.numpy`` (engine); pass ``xp`` where an
explicit module is needed (``cross``).
"""

from __future__ import annotations

import jax.numpy as jnp

NEAR_ZERO_EPS = 1e-8  # Vec3.h:58


def dot(u, v):
    """Dot product over the trailing 3-axis (Vec3.h:108-113)."""
    return (u * v).sum(-1)


def length_squared(v):
    return (v * v).sum(-1)


def length(v):
    return length_squared(v) ** 0.5


def cross(u, v, xp=jnp):
    """Cross product (Vec3.h:115-120)."""
    return xp.stack(
        (
            u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
            u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
            u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0],
        ),
        axis=-1,
    )


def unit_vector(v):
    """v / |v| (Vec3.h:122-125)."""
    return v / length(v)[..., None]


def near_zero(v):
    """True where all three components are below 1e-8 (Vec3.h:56-63)."""
    a = abs(v)
    return (a[..., 0] < NEAR_ZERO_EPS) & (a[..., 1] < NEAR_ZERO_EPS) & (a[..., 2] < NEAR_ZERO_EPS)


def reflect(v, n):
    """Mirror reflection about normal n (Vec3.h:127-130)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, eta_ratio):
    """Snell refraction of unit vector ``uv`` about ``n`` (Vec3.h:132-141).

    ``eta_ratio`` broadcasts against the batch shape (shape ``(...,)``).
    """
    cos_theta = dot(-uv, n).clip(None, 1.0)  # fmin(dot, 1.0), Vec3.h:134
    r_perp = eta_ratio[..., None] * (uv + cos_theta[..., None] * n)
    # NaN-safe root at the total-internal-reflection boundary: sqrt has an
    # infinite derivative at 0, and a zero-weighted cotangent there is
    # 0 x inf = NaN in reverse mode.  Forward-identical (guarded branch = 0).
    import numpy as _np

    k = abs(1.0 - length_squared(r_perp))
    xp = _np if isinstance(k, _np.ndarray) else jnp
    pos = k > 0
    r_par = -(xp.where(pos, xp.where(pos, k, 1.0) ** 0.5, 0.0))[..., None] * n
    return r_perp + r_par

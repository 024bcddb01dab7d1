"""A seeded scene of Gaussians that stresses the cull of the alpha-blend
kernels K8 and K9 (``ops/rasterize_blend.py``'s ``blend_cull_plain``, the
mirror of ``slot_cull`` in ``ops/csrc/rasterize_blend_common.cuh``): the
rows where a rectangle that is one rounding too small would lose a pair
that composites. Test data only: the cull's CPU tests and
``chip_smoke.py``'s cull_edge cases draw from it, and nothing on the
package's paths imports it.
"""

import math

import numpy as np

from gaussianimage_tpu_torch.ops.rasterize_blend import BlendConfig

ALPHA_MIN = BlendConfig().alpha_min  # the blend's default gate, 1 / 255


def cull_edge_scene(n: int, H: int, W: int, seed: int) -> dict:
    """A seeded scene of n Gaussians that stress the cull: conics rotated
    up to 1e4 : 1, near-singular, not positive definite and a few NaN;
    thin ellipses (condition 1e2..3e6) whose far tip lands in the image,
    where the float32 form's rounding is largest against the rectangle's
    edge; opacities at ALPHA_MIN (1 -+ 1e-6), 0.1, 0.999 and 1 and a few
    NaN; centers on 8 x 4 patch borders (and just off them) and anywhere in
    or around the H x W image. Float32 numpy arrays: xys [n, 2], depths
    [n], radii [n] (the binning's: 2-40 px, a thin ellipse's its half
    length), conics [n, 3], colors [n, 3], opac [n]. The cull's CPU tests
    and chip_smoke.py's cull_edge case use it."""
    rng = np.random.default_rng(seed)
    kind = rng.choice(5, n, p=[0.4, 0.15, 0.15, 0.05, 0.25])
    opac = rng.choice(np.array([ALPHA_MIN * (1 - 1e-6), ALPHA_MIN * (1 + 1e-6),
                                0.1, 0.999, 1.0]), n)
    thin = kind == 4
    opac[thin] = rng.choice(np.array([0.1, 0.999, 1.0]), int(thin.sum()))
    lam1 = 10.0 ** rng.uniform(-2.5, 0.5, n)
    lam2 = lam1 / 10.0 ** rng.uniform(0.0, 4.0, n)
    # thin: the long half axis 8-96 px at q = 2 log(o / ALPHA_MIN)
    half = rng.uniform(8.0, 96.0, n)
    lam2 = np.where(thin, 2.0 * np.log(opac / ALPHA_MIN) / half ** 2, lam2)
    lam1 = np.where(thin, 4.0 * 10.0 ** rng.uniform(2.0, 6.5, n) * lam2, lam1)
    th = rng.uniform(0.0, math.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    a = lam1 * cs * cs + lam2 * sn * sn
    c = lam1 * sn * sn + lam2 * cs * cs
    b = (lam1 - lam2) * sn * cs
    sgn = rng.choice([-1.0, 1.0], n)
    # near-singular: b^2 within 1e-7..1e-2 of ac
    near = sgn * np.sqrt(a * c) * (1.0 - 10.0 ** rng.uniform(-7.0, -2.0, n))
    b = np.where(kind == 1, near, b)
    # not positive definite: b^2 > ac, or a negative diagonal, or zero
    nonpd = rng.choice(3, n)
    b = np.where((kind == 2) & (nonpd == 0),
                 sgn * np.sqrt(a * c) * rng.uniform(1.0, 3.0, n), b)
    a = np.where((kind == 2) & (nonpd == 1), -a, a)
    zero = (kind == 2) & (nonpd == 2)
    a, b, c = (np.where(zero, 0.0, v) for v in (a, b, c))
    conics = np.stack([a, b, c], -1)
    nan_at = rng.integers(0, 3, n)
    conics[np.arange(n)[kind == 3], nan_at[kind == 3]] = np.nan
    opac[rng.random(n) < 0.02] = np.nan
    border = rng.random(n) < 0.5
    off = rng.choice(np.array([0.0, 1e-3, -1e-3, 0.5, -0.5]), (n, 2))
    grid = np.stack([8.0 * rng.integers(-1, W // 8 + 2, n),
                     4.0 * rng.integers(-1, H // 4 + 2, n)], -1) + off
    anywhere = rng.uniform([-8.0, -8.0], [W + 8.0, H + 8.0], (n, 2))
    xys = np.where(border[:, None], grid, anywhere)
    # a thin ellipse's far tip at that point: its center half a length off
    axis = np.stack([-sn, cs], -1) * sgn[:, None]
    xys = np.where(thin[:, None],
                   xys - axis * (half * rng.uniform(0.97, 1.03, n))[:, None],
                   xys)
    radii = np.where(thin, 1.05 * half + 2.0, rng.uniform(2, 40, n))
    f32 = np.float32
    return {"xys": xys.astype(f32),
            "depths": rng.uniform(1, 10, n).astype(f32),
            "radii": radii.astype(f32), "conics": conics.astype(f32),
            "colors": rng.uniform(0, 1, (n, 3)).astype(f32),
            "opac": opac.astype(f32)}

"""Toy lifting distributions: von Mises mixtures on circle and torus.

Rebuild of ``toy_experiment/data/distributions.py`` and
``data/scenarios.py``. The reference samples its torus distribution with
pyro's ``SineBivariateVonMises`` but always passes ``correlation=0``
(``distributions.py:198,307``), where the density factorizes into two
*independent* von Mises factors — so sampling here is plain numpy and the
pyro dependency is dropped. The reference's mixture pdf also omits the
phi-concentration factor in the exponent (``distributions.py:164-167``);
this build computes the correct factorized density.

The port's own copy of ``manipose_tpu/toy/distributions.py`` (numpy and
scipy only; the port imports nothing of the JAX package). It draws from
numpy ``RandomState`` as that module does, so the same seeds give the same
samples bit for bit.
"""

from __future__ import annotations

import numbers
from typing import Tuple

import numpy as np
from scipy.special import i0


def polar2cartesian(radius, angles):
    return radius * np.cos(angles), radius * np.sin(angles)


def torus_angles_to_cartesian(
    major_radius: float, minor_radius: float, angles: np.ndarray
) -> np.ndarray:
    """(N, 2) torus angles (theta, phi) -> (N, 3) points
    (``distributions.py:99-115``)."""
    x = (major_radius + minor_radius * np.cos(angles[:, 0])) * np.cos(angles[:, 1])
    y = (major_radius + minor_radius * np.cos(angles[:, 0])) * np.sin(angles[:, 1])
    z = minor_radius * np.sin(angles[:, 0])
    return np.stack((x, y, z), axis=1)


def torus_cartesian_to_angles(
    major_radius: float, minor_radius: float, points: np.ndarray
) -> np.ndarray:
    """(N, 3) -> (N, 2) (phi, theta) (``distributions.py:117-141``)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    phi = np.arctan2(y, x)
    r = np.sqrt(x**2 + y**2)
    theta = np.arctan2(z, r - major_radius)
    theta = (theta + 2 * np.pi) % (2 * np.pi)
    return np.column_stack((phi, theta))


class MixtureVonMises:
    """Univariate von Mises mixture (``distributions.py:11-58``)."""

    def __init__(self, weights, modes, dispersions, random_state):
        assert abs(sum(weights) - 1) <= 1e-6
        self.weights = np.asarray(weights, dtype=float)
        assert (self.weights >= 0).all()
        self.modes = np.asarray(modes, dtype=float)
        self.dispersions = np.asarray(dispersions, dtype=float)
        assert (
            self.weights.shape[0] == self.modes.shape[0] == self.dispersions.shape[0]
        )
        self.rng = np.random.RandomState(random_state)
        self.components = np.arange(self.weights.shape[0])

    def sample(self, size: int) -> np.ndarray:
        picked = self.rng.choice(self.components, size=size, p=self.weights)
        samples = np.empty(size)
        for c, mu, kappa in zip(self.components, self.modes, self.dispersions):
            mask = picked == c
            samples[mask] = self.rng.vonmises(mu, kappa=kappa, size=int(mask.sum()))
        return samples

    def pdf(self, theta) -> np.ndarray:
        theta = np.atleast_1d(np.asarray(theta, dtype=float))[:, None]
        return np.sum(
            self.weights
            * np.exp(self.dispersions * np.cos(theta - self.modes))
            / (2 * np.pi * i0(self.dispersions)),
            axis=1,
        )


class BivariateVonMisesMixture:
    """Mixture of zero-correlation sine-bivariate von Mises on the torus
    (``distributions.py:75-204``); each component factorizes into two
    independent von Mises distributions."""

    def __init__(self, weights, modes, dispersions, random_state: int = 1234):
        assert abs(sum(weights) - 1) <= 1e-5
        self.weights = np.asarray(weights, dtype=float)
        assert (self.weights >= 0).all()
        self.modes = np.asarray(modes, dtype=float)  # (K, 2)
        self.dispersions = np.asarray(dispersions, dtype=float)  # (K, 2)
        assert (
            self.weights.shape[0] == self.modes.shape[0] == self.dispersions.shape[0]
        )
        self.rng = np.random.RandomState(random_state)
        self.components = np.arange(self.weights.shape[0])
        self.picked_components = None

    def sample(self, size: int) -> np.ndarray:
        self.picked_components = self.rng.choice(
            self.components, size=size, p=self.weights
        )
        samples = np.empty((size, 2))
        for c, mu, kappa in zip(self.components, self.modes, self.dispersions):
            mask = self.picked_components == c
            n = int(mask.sum())
            phi = self.rng.vonmises(mu[0], kappa=kappa[0], size=n)
            psi = self.rng.vonmises(mu[1], kappa=kappa[1], size=n)
            samples[mask] = np.column_stack((phi, psi))
        return samples

    def pdf(self, angles: np.ndarray) -> np.ndarray:
        angles = np.asarray(angles, dtype=float)
        phi = angles[:, 0:1]
        psi = angles[:, 1:2]
        k1 = self.dispersions[:, 0]
        k2 = self.dispersions[:, 1]
        comp = (
            np.exp(
                k1 * np.cos(phi - self.modes[:, 0])
                + k2 * np.cos(psi - self.modes[:, 1])
            )
            / ((2 * np.pi) ** 2 * i0(k1) * i0(k2))
        )
        return np.sum(self.weights * comp, axis=1)


class LiftingDist1Dto2D(MixtureVonMises):
    """x-coordinate -> point on circle (``distributions.py:264-281``)."""

    def __init__(self, radius, weights, modes, dispersions, random_state):
        super().__init__(weights, modes, dispersions, random_state)
        assert isinstance(radius, numbers.Real) and radius > 0
        self.radius = radius

    def sample(self, size: int) -> Tuple[np.ndarray, np.ndarray]:
        angles = super().sample(size)
        x, y = polar2cartesian(self.radius, angles)
        return x, np.hstack([x[:, None], y[:, None]])


class LiftingDist2Dto3D(BivariateVonMisesMixture):
    """(x, z) -> point on torus (``distributions.py:286-319``)."""

    def __init__(
        self, major_radius, minor_radius, weights, modes, dispersions, random_state
    ):
        super().__init__(weights, modes, dispersions, random_state)
        assert major_radius > 0 and minor_radius > 0
        self.major_radius = major_radius
        self.minor_radius = minor_radius

    def torusanglestocartesian(self, major_radius, minor_radius, angles):
        return torus_angles_to_cartesian(major_radius, minor_radius, angles)

    def torus_cartesian_to_angles_batch(self, major_radius, minor_radius, points):
        return torus_cartesian_to_angles(major_radius, minor_radius, points)

    def sample(self, size: int, output_components: bool = False):
        angles = super().sample(size)
        pts = torus_angles_to_cartesian(self.major_radius, self.minor_radius, angles)
        inputs = np.stack((pts[:, 0], pts[:, 2]), axis=-1)
        if output_components:
            return inputs, pts, self.picked_components
        return inputs, pts


# ---- scenario presets (``data/scenarios.py``) -----------------------------

class EasyDist(LiftingDist1Dto2D):
    def __init__(self, radius: float, random_state: int):
        super().__init__(
            radius=radius, weights=[1.0], modes=[4 * np.pi / 10],
            dispersions=[20], random_state=random_state,
        )


class HardUnimodalDist(LiftingDist1Dto2D):
    def __init__(self, radius: float, random_state: int):
        super().__init__(
            radius=radius, weights=[1.0], modes=[0.0],
            dispersions=[20], random_state=random_state,
        )


class HardBimodalDist(LiftingDist1Dto2D):
    def __init__(self, radius: float, random_state: int):
        super().__init__(
            radius=radius, weights=[2 / 3, 1 / 3],
            modes=[np.pi / 3, -np.pi / 3], dispersions=[20] * 2,
            random_state=random_state,
        )


class HardQuadmodalDist(LiftingDist1Dto2D):
    def __init__(self, radius: float, random_state: int):
        super().__init__(
            radius=radius, weights=[0.3, 0.1, 0.4, 0.2],
            modes=[5 * np.pi / 6, 7 * np.pi / 6, np.pi / 3, -np.pi / 3],
            dispersions=[20] * 4, random_state=random_state,
        )


def torus_scenario(major_radius, minor_radius, random_state):
    """The paper's torus-2Dto3D preset (``toy_experiment/main.py:70-77``)."""
    return LiftingDist2Dto3D(
        major_radius=major_radius,
        minor_radius=minor_radius,
        weights=[0.3, 0.4, 0.2, 0.1],
        modes=[(-3.1415, 0), (0, 3.1415 / 4), (0.5, -3.1415 / 4),
               (2 * 3.1415 / 3, 3.1415 / 2)],
        dispersions=[(2, 2), (4, 4), (3, 3), (10, 10)],
        random_state=random_state,
    )

"""Frechet Inception Distance / Kernel Inception Distance over pool3
features (a copy of ``dsgan_tpu/ops/fid.py``, which the port does not
import: ``activation_stats``, ``frechet_distance``, ``fid_from_features``,
``kid_from_features``, float64 numpy and scipy on the host; the matrix
square root is a plain ``scipy.linalg.sqrtm``, which every scipy release
takes).

The features come from ``models/inception.py`` on the card; the Frechet
distance's matrix square root is one 2048x2048 eigenproblem per
evaluation, which runs on the host.
"""

import numpy as np


def activation_stats(feats):
    """(N, d) feature matrix -> (mu, sigma) with the unbiased covariance
    (rowvar=False), the FID convention."""
    feats = np.asarray(feats, np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrtm(s1 s2)).

    Non-finite sqrtm (singular products) gets the standard eps*I jitter;
    tiny imaginary residue from the complex branch is dropped after a
    sanity bound, matching the widely used reference implementation's
    numerics (so numbers are comparable).
    """
    from scipy import linalg

    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    diff = mu1 - mu2

    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"sqrtm produced large imaginary component "
                f"{np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid_from_features(feats1, feats2):
    m1, s1 = activation_stats(feats1)
    m2, s2 = activation_stats(feats2)
    return frechet_distance(m1, s1, m2, s2)


def kid_from_features(feats1, feats2, subset_size=None, n_subsets=100,
                      seed=0):
    """Kernel Inception Distance: unbiased MMD^2 with the polynomial
    kernel k(x,y) = (x.y/d + 1)^3, averaged over random subsets (the
    standard estimator). Returns (mean, std) of the subset estimates."""
    f1 = np.asarray(feats1, np.float64)
    f2 = np.asarray(feats2, np.float64)
    n = min(len(f1), len(f2))
    if subset_size is None:
        subset_size = min(1000, n)
    subset_size = min(subset_size, n)
    d = f1.shape[1]
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(n_subsets):
        a = f1[rng.choice(len(f1), subset_size, replace=False)]
        b = f2[rng.choice(len(f2), subset_size, replace=False)]
        kaa = (a @ a.T / d + 1.0) ** 3
        kbb = (b @ b.T / d + 1.0) ** 3
        kab = (a @ b.T / d + 1.0) ** 3
        m = subset_size
        mmd = ((kaa.sum() - np.trace(kaa)) / (m * (m - 1))
               + (kbb.sum() - np.trace(kbb)) / (m * (m - 1))
               - 2.0 * kab.mean())
        vals.append(mmd)
    vals = np.asarray(vals)
    return float(vals.mean()), float(vals.std())

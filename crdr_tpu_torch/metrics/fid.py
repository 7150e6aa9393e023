"""FID with the HiFiC patch protocol (reference calc_metrics.py:219-318;
the port's own copy of ``crdr_tpu/metrics/fid.py``).

Patch protocol: a non-overlapping 256px block grid plus a half-patch-shifted
grid per image; FID over all patches of >= 50 images.  The crop and the
statistics (``np.cov``, scipy's ``sqrtm``, float64) run on the host, as in
the JAX package; the feature extractor (``metrics/inception.py``'s
``make_inception_extractor``) takes the patches to the card in batches.
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import numpy as np


def crop_hific_fid_patches(img: np.ndarray, patch_size: int = 256
                           ) -> np.ndarray:
    """HWC uint8/float -> [N, p, p, C]: block grid + half-shifted block
    grid."""
    p = patch_size
    H, W = img.shape[:2]
    out = []
    if H // p and W // p:
        a = img[: H // p * p, : W // p * p]
        a = a.reshape(H // p, p, W // p, p, -1).transpose(0, 2, 1, 3, 4)
        out.append(a.reshape(-1, p, p, img.shape[2]))
    o = p // 2
    sH, sW = H - o, W - o
    if sH // p and sW // p:
        b = img[o: o + sH // p * p, o: o + sW // p * p]
        b = b.reshape(sH // p, p, sW // p, p, -1).transpose(0, 2, 1, 3, 4)
        out.append(b.reshape(-1, p, p, img.shape[2]))
    if not out:
        return np.zeros((0, p, p, img.shape[2]), img.dtype)
    return np.concatenate(out, axis=0)


def activation_statistics(features: np.ndarray):
    """features: [N, D] -> (mu [D], sigma [D, D])."""
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2))."""
    from scipy import linalg

    diff = mu1 - mu2
    # the matrix alone (the same value as ``disp=False``'s first output;
    # newer scipy has no ``disp``)
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def compute_fid(real_feats: np.ndarray, fake_feats: np.ndarray) -> float:
    mu1, s1 = activation_statistics(real_feats)
    mu2, s2 = activation_statistics(fake_feats)
    return frechet_distance(mu1, s1, mu2, s2)


def patch_features(imgs: Iterable[np.ndarray],
                   extractor: Callable[[np.ndarray], np.ndarray],
                   patch_size: int = 256, batch_size: int = 50
                   ) -> np.ndarray:
    """The extractor's features of every HiFiC patch of ``imgs``, in
    batches of ``batch_size`` patches (the last one shorter)."""
    patches: List[np.ndarray] = []
    out: List[np.ndarray] = []
    for img in imgs:
        patches.append(crop_hific_fid_patches(img, patch_size))
        while sum(p.shape[0] for p in patches) >= batch_size:
            block = np.concatenate(patches, axis=0)
            out.append(np.asarray(extractor(block[:batch_size])))
            patches = [block[batch_size:]]
    rest = np.concatenate(patches, axis=0) if patches else None
    if rest is not None and rest.shape[0]:
        out.append(np.asarray(extractor(rest)))
    return np.concatenate(out, axis=0)


def fid_from_image_lists(real_imgs: Iterable[np.ndarray],
                         fake_imgs: Iterable[np.ndarray],
                         extractor: Callable[[np.ndarray], np.ndarray],
                         patch_size: int = 256,
                         batch_size: int = 50) -> float:
    """Full HiFiC-protocol FID from in-memory uint8 HWC images."""
    return compute_fid(
        patch_features(real_imgs, extractor, patch_size, batch_size),
        patch_features(fake_imgs, extractor, patch_size, batch_size))


def mean_pool_extractor(batch: np.ndarray) -> np.ndarray:
    """Cheap deterministic feature extractor (tests only): downsampled RGB
    means, NOT a perceptual feature space."""
    x = batch.astype(np.float32) / 255.0
    n, h, w, c = x.shape
    f = x.reshape(n, 8, h // 8, 8, w // 8, c).mean(axis=(2, 4))
    return f.reshape(n, -1)

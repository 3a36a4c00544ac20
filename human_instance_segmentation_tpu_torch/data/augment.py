"""ROI-safe augmentations (host-side numpy).

Counterpart of the JAX package's ``data/augment.py``, a copy of its numpy
and PIL code: the same generator gives the same sample byte for byte. It
redesigns the reference's albumentations pipelines
(``src/human_edge_detection/augmentations.py:16-274``): **no geometric
transforms except horizontal flip** (which updates boxes and masks
consistently), because anything else would break ROI alignment between the
image and the normalised boxes. Photometric transforms (brightness,
contrast, saturation, hue, gamma, blur, noise, weather, compression) change
the image only.

Each transform is a pure function (sample, rng) -> sample operating on:
    image (H, W, 3) float32 [0, 1]
    boxes (K, 4) normalised [x1, y1, x2, y2]
    masks (K, mh, mw) or full-size masks, flipped consistently.
The draws come from the ``np.random.Generator`` the caller passes, in a
fixed order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


def hflip(sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Horizontal flip of image + normalised boxes + per-ROI masks."""
    out = dict(sample)
    out["image"] = sample["image"][:, ::-1, :].copy()
    boxes = sample["boxes"].copy()
    x1 = boxes[:, 0].copy()
    boxes[:, 0] = 1.0 - sample["boxes"][:, 2]
    boxes[:, 2] = 1.0 - x1
    out["boxes"] = boxes
    if "masks" in sample:
        out["masks"] = sample["masks"][:, :, ::-1].copy()
    if "full_mask" in sample:
        out["full_mask"] = sample["full_mask"][:, ::-1].copy()
    return out


def _blend(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    return np.clip(a * (1.0 - t) + b * t, 0.0, 1.0)


def brightness_contrast(img: np.ndarray, rng: np.random.Generator,
                        brightness: float = 0.2, contrast: float = 0.2) -> np.ndarray:
    img = np.clip(img + rng.uniform(-brightness, brightness), 0.0, 1.0)
    c = 1.0 + rng.uniform(-contrast, contrast)
    return np.clip((img - img.mean()) * c + img.mean(), 0.0, 1.0)


def saturation_hue(img: np.ndarray, rng: np.random.Generator,
                   saturation: float = 0.2, hue: float = 0.05) -> np.ndarray:
    gray = img.mean(axis=-1, keepdims=True)
    img = _blend(gray, img, 1.0 + rng.uniform(-saturation, saturation))
    # cheap hue-ish: rotate channels slightly
    shift = rng.uniform(-hue, hue)
    mix = np.clip(img + shift * (np.roll(img, 1, axis=-1) - img), 0.0, 1.0)
    return mix


def gamma(img: np.ndarray, rng: np.random.Generator, limit: float = 0.2) -> np.ndarray:
    g = 1.0 + rng.uniform(-limit, limit)
    return np.clip(img, 1e-6, 1.0) ** g


def gaussian_noise(img: np.ndarray, rng: np.random.Generator, sigma: float = 0.02) -> np.ndarray:
    return np.clip(img + rng.normal(0.0, sigma, img.shape).astype(img.dtype), 0.0, 1.0)


def gaussian_blur(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    k = np.asarray([1.0, 2.0, 1.0], img.dtype)
    k /= k.sum()
    out = img
    for axis in (0, 1):
        pad = [(0, 0)] * 3
        pad[axis] = (1, 1)
        p = np.pad(out, pad, mode="edge")
        sl = [slice(None)] * 3
        acc = np.zeros_like(out)
        for i, w in enumerate(k):
            sl[axis] = slice(i, i + out.shape[axis])
            acc += w * p[tuple(sl)]
        out = acc
    return out


# ---------------------------------------------------------------------------
# Weather family (augmentations.py:91-99: RandomRain / RandomFog /
# RandomSunFlare — photometric only, ROI-safe)
# ---------------------------------------------------------------------------


def rain(img: np.ndarray, rng: np.random.Generator, n_drops: int = 150,
         drop_length: int = 12, brightness: float = 0.7) -> np.ndarray:
    """Light-gray streak overlay (RandomRain, drop_color ~(200,200,200))."""
    h, w = img.shape[:2]
    out = img.copy()
    ys = rng.integers(0, max(h - drop_length, 1), n_drops)
    xs = rng.integers(0, w, n_drops)
    slant = int(rng.integers(-3, 4))
    for y0, x0 in zip(ys, xs):
        for t in range(drop_length):
            y = y0 + t
            x = x0 + (t * slant) // max(drop_length, 1)
            if 0 <= y < h and 0 <= x < w:
                out[y, x] = out[y, x] * 0.5 + brightness * 0.5
    # rain scenes read slightly darker overall
    return np.clip(out * 0.92, 0.0, 1.0)


def fog(img: np.ndarray, rng: np.random.Generator, alpha: float = 0.3) -> np.ndarray:
    """Blend toward white with a smooth low-frequency alpha field
    (RandomFog, alpha_coef=0.1)."""
    h, w = img.shape[:2]
    coarse = rng.random((4, 4)).astype(np.float32)
    # bilinear upsample of the coarse field to (h, w)
    yi = np.linspace(0, 3, h)
    xi = np.linspace(0, 3, w)
    y0 = np.floor(yi).astype(int)
    x0 = np.floor(xi).astype(int)
    y1 = np.minimum(y0 + 1, 3)
    x1 = np.minimum(x0 + 1, 3)
    fy = (yi - y0)[:, None]
    fx = (xi - x0)[None, :]
    field = (coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
             + coarse[np.ix_(y1, x0)] * fy * (1 - fx)
             + coarse[np.ix_(y0, x1)] * (1 - fy) * fx
             + coarse[np.ix_(y1, x1)] * fy * fx)
    a = (alpha * (0.5 + field))[..., None].astype(img.dtype)
    return np.clip(img * (1 - a) + 1.0 * a, 0.0, 1.0)


def sun_flare(img: np.ndarray, rng: np.random.Generator,
              intensity: float = 0.5) -> np.ndarray:
    """Additive radial highlight in the upper half (RandomSunFlare)."""
    h, w = img.shape[:2]
    cy = rng.integers(0, max(h // 2, 1))
    cx = rng.integers(0, w)
    radius = max(min(h, w) // 4, 1)
    yy, xx = np.mgrid[0:h, 0:w]
    d2 = ((yy - cy) ** 2 + (xx - cx) ** 2).astype(np.float32)
    glow = intensity * np.exp(-d2 / (2.0 * radius * radius))
    return np.clip(img + glow[..., None], 0.0, 1.0)


# ---------------------------------------------------------------------------
# Compression / degradation family (augmentations.py:112-118: ISONoise /
# ImageCompression / Downscale)
# ---------------------------------------------------------------------------


def iso_noise(img: np.ndarray, rng: np.random.Generator,
              color_shift: float = 0.03, intensity: float = 0.3) -> np.ndarray:
    """Sensor-style noise: luminance-dependent gaussian + per-channel color
    shift (ISONoise)."""
    luma = img.mean(axis=-1, keepdims=True)
    noise = rng.normal(0.0, intensity * 0.1, img.shape).astype(img.dtype)
    noise *= np.sqrt(np.clip(luma, 1e-3, 1.0))
    shift = rng.uniform(-color_shift, color_shift, (1, 1, 3)).astype(img.dtype)
    return np.clip(img + noise + shift, 0.0, 1.0)


def jpeg_compression(img: np.ndarray, rng: np.random.Generator,
                     quality_range=(70, 95)) -> np.ndarray:
    """Real JPEG round trip at a random quality (ImageCompression)."""
    import io

    from PIL import Image

    q = int(rng.integers(quality_range[0], quality_range[1] + 1))
    im = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    buf = io.BytesIO()
    im.save(buf, format="JPEG", quality=q)
    buf.seek(0)
    return np.asarray(Image.open(buf), dtype=np.float32) / 255.0


def downscale(img: np.ndarray, rng: np.random.Generator,
              scale_range=(0.5, 0.9)) -> np.ndarray:
    """Down- then up-sample (Downscale): low-res look at original size."""
    from PIL import Image

    h, w = img.shape[:2]
    s = rng.uniform(*scale_range)
    lw, lh = max(int(w * s), 1), max(int(h * s), 1)
    im = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    im = im.resize((lw, lh), Image.BILINEAR).resize((w, h), Image.BILINEAR)
    return np.asarray(im, dtype=np.float32) / 255.0


@dataclass
class AugmentConfig:
    hflip_prob: float = 0.5
    color_prob: float = 0.5
    gamma_prob: float = 0.3
    blur_prob: float = 0.1
    noise_prob: float = 0.1
    weather_prob: float = 0.1      # heavy only: rain | fog | sun flare
    compression_prob: float = 0.2  # heavy only: iso noise | jpeg | downscale
    heavy: bool = False


def augment_sample(sample: Dict[str, np.ndarray], rng: np.random.Generator,
                   cfg: Optional[AugmentConfig] = None) -> Dict[str, np.ndarray]:
    cfg = cfg or AugmentConfig()
    if rng.random() < cfg.hflip_prob:
        sample = hflip(sample)
    img = sample["image"]
    if rng.random() < cfg.color_prob:
        img = brightness_contrast(img, rng)
        img = saturation_hue(img, rng)
    if rng.random() < cfg.gamma_prob:
        img = gamma(img, rng)
    if cfg.heavy and rng.random() < cfg.blur_prob:
        img = gaussian_blur(img, rng)
    if cfg.heavy and rng.random() < cfg.noise_prob:
        img = gaussian_noise(img, rng)
    if cfg.heavy and rng.random() < cfg.weather_prob:
        img = [rain, fog, sun_flare][int(rng.integers(0, 3))](img, rng)
    if cfg.heavy and rng.random() < cfg.compression_prob:
        img = [iso_noise, jpeg_compression, downscale][int(rng.integers(0, 3))](img, rng)
    out = dict(sample)
    out["image"] = img.astype(np.float32)
    return out

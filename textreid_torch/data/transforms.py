"""Image transform pipeline.

Replicates the reference's torchvision chain
(`reference/lib/data/transforms.py:4-43`) with PIL + numpy, producing
HWC float32 (the models take NHWC and permute on the device):

* train+aug:  Resize -> HFlip(0.5) -> Pad(10) -> RandomCrop -> scale to [0,1]
  -> Normalize -> RandomErasing(p=0.5, scale=(0.02,0.4), value=pixel_mean)
* train no-aug: Resize -> HFlip(0.5) -> scale -> Normalize
* eval:       Resize -> scale -> Normalize

RandomErasing keeps torchvision's quirk of filling the *normalized* image
with the raw pixel-mean values (transforms.py:24).

Two output modes:

* ``device_prep=False`` — everything on host, float32 normalized output
  (bit-compatible with the reference chain; used by parity tests).
* ``device_prep=True`` (default pipeline) — the accelerator split: the host
  does only the uint8 geometry (resize/flip/pad-crop) and *samples* the
  erase rectangle; the batch ships as uint8 (4x less host->device traffic)
  plus a 5-int erase descriptor, and ``/255 -> normalize -> rectangle
  fill`` runs on the device
  (``models.model.preprocess_pixels``).  Host RNG decides all randomness
  either way, so the device step stays pure.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
from PIL import Image


class Transform:
    def __init__(
        self,
        height: int,
        width: int,
        pixel_mean,
        pixel_std,
        is_train: bool,
        use_aug: bool,
        padding: int = 10,
        erase_prob: float = 0.5,
        erase_scale: Tuple[float, float] = (0.02, 0.4),
        erase_ratio: Tuple[float, float] = (0.3, 10 / 3),
        rng: Optional[np.random.RandomState] = None,
        device_prep: bool = True,
    ):
        self.height = height
        self.width = width
        self.mean = np.asarray(pixel_mean, dtype=np.float32)
        self.std = np.asarray(pixel_std, dtype=np.float32)
        self.is_train = is_train
        self.use_aug = use_aug
        self.padding = padding
        self.erase_prob = erase_prob
        self.erase_scale = erase_scale
        self.erase_ratio = erase_ratio
        self.rng = rng or np.random.RandomState(0)
        self.device_prep = device_prep

    def seed(self, seed: int) -> None:
        self.rng = np.random.RandomState(seed)

    def __call__(self, img: Image.Image, rng=None):
        """Returns (pixels, erase) — pixels uint8 HWC in device_prep mode
        (normalize+erase applied later on device) or float32 normalized
        otherwise; erase is a length-5 int32 [apply, top, left, h, w].

        Pass a per-sample ``rng`` for deterministic augmentation independent
        of worker-thread scheduling (the loader derives one from
        (seed, epoch, sample position))."""
        rng = self.rng if rng is None else rng
        img = img.resize((self.width, self.height), Image.BILINEAR)

        if self.is_train:
            if rng.rand() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if self.use_aug:
                img = self._pad_and_crop(img, rng)

        erase = np.zeros(5, dtype=np.int32)
        if self.is_train and self.use_aug:
            erase = self._sample_erase(rng)

        if self.device_prep:
            return np.asarray(img, dtype=np.uint8), erase

        arr = np.asarray(img, dtype=np.float32) / 255.0
        arr = (arr - self.mean) / self.std
        if erase[0]:
            top, left, eh, ew = erase[1:]
            arr[top : top + eh, left : left + ew] = self.mean
        return arr, erase

    def _pad_and_crop(self, img: Image.Image, rng) -> Image.Image:
        p = self.padding
        padded = Image.new("RGB", (img.width + 2 * p, img.height + 2 * p), (0, 0, 0))
        padded.paste(img, (p, p))
        left = int(rng.randint(0, 2 * p + 1))
        top = int(rng.randint(0, 2 * p + 1))
        return padded.crop((left, top, left + self.width, top + self.height))

    def _sample_erase(self, rng) -> np.ndarray:
        """Sample the torchvision RandomErasing rectangle (p=0.5, 10
        attempts); returns [apply, top, left, h, w] int32."""
        out = np.zeros(5, dtype=np.int32)
        if rng.rand() >= self.erase_prob:
            return out
        h, w = self.height, self.width
        area = h * w
        log_ratio = (math.log(self.erase_ratio[0]), math.log(self.erase_ratio[1]))
        for _ in range(10):
            erase_area = area * rng.uniform(*self.erase_scale)
            aspect = math.exp(rng.uniform(*log_ratio))
            eh = int(round(math.sqrt(erase_area * aspect)))
            ew = int(round(math.sqrt(erase_area / aspect)))
            if 0 < eh < h and 0 < ew < w:
                top = int(rng.randint(0, h - eh + 1))
                left = int(rng.randint(0, w - ew + 1))
                out[:] = (1, top, left, eh, ew)
                return out
        return out


def build_transforms(cfg, is_train: bool = True, rng=None,
                     device_prep: bool = False) -> Transform:
    """Mirrors reference transforms.py:4-43."""
    return Transform(
        height=cfg.INPUT.HEIGHT,
        width=cfg.INPUT.WIDTH,
        pixel_mean=cfg.INPUT.PIXEL_MEAN,
        pixel_std=cfg.INPUT.PIXEL_STD,
        is_train=is_train,
        use_aug=cfg.INPUT.USE_AUG,
        padding=cfg.INPUT.PADDING,
        rng=rng,
        device_prep=device_prep,
    )

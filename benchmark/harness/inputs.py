"""Everything a run is given, made from its ``--seed``: the weights and the
MoCo queues (on the device, one ``torch.Generator`` on the card, one large
draw), and the traffic of a mix file: a ring of training batches held on
the device, or a synthetic CUHK-PEDES test split held in host memory as
the test loader yields it.

The sizes a seed draws are the same for every seed: caption lengths are a
fixed set of quantiles of the mix's length distribution, shuffled by the
seed, so two seeds give the program the same work in another order."""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np
import torch

# the streams of a seed besides the weights': queues, pixels, and the
# images that settle BatchNorm's running statistics
QUEUE_SALT, PIXEL_SALT, SETTLE_SALT = 0x5EED0001, 0x5EED0002, 0x5EED0003


# the scale a bottleneck's last BatchNorm starts at (cf. the zero-gamma
# initialisation of Goyal et al., 2017): at 1, a random-weight ResNet-50 with
# batch statistics is chaotic, and its bfloat16 round-off grows through the
# 16 blocks to a third of the features, as much as float8's does
RESIDUAL_SCALE = 0.2


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (2 ** 63))


def make_weights(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: f32 tensor}`` for ``spec`` (``reference.model.param_spec``):
    one normal draw cut into the leaves, each scaled by its kind: products
    ``1 / sqrt(fan_in)``, norms ``1 + 0.05 z`` (a residual branch's last
    ``RESIDUAL_SCALE`` times that), biases ``0.02 z``, position and class
    embeddings ``1 / sqrt(width)``, the token table ``z``, running
    statistics 0 and 1."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    flat = torch.randn(sum(sizes), generator=_generator(device, seed),
                       device=device)
    out, start = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        z = flat[start:start + n].view(shape)
        start += n
        if kind in ("conv", "matrix"):
            z.mul_(math.prod(shape[1:]) ** -0.5)
        elif kind == "matrix_t":
            z.mul_(shape[0] ** -0.5)
        elif kind == "norm":
            z.mul_(0.05).add_(1.0)
        elif kind == "norm_residual":
            z.mul_(0.05).add_(1.0).mul_(RESIDUAL_SCALE)
        elif kind == "bias":
            z.mul_(0.02)
        elif kind == "embedding":
            z.mul_(shape[-1] ** -0.5)
        elif kind == "running_mean":
            z.zero_()
        elif kind == "running_var":
            z.fill_(1.0)
        elif kind != "table":
            raise ValueError(f"unknown kind {kind!r} of {name}")
        out[name] = z
    return out


def settle_batchnorm(weights: Dict[str, torch.Tensor], cfg: dict,
                     pixels: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to the batch statistics
    of ``pixels`` under these weights (the reference's training forward,
    layer by layer in order), so that an evaluation normalises as a
    trained network does rather than passing its activations' means on."""
    from ..reference.model import batch_statistics

    stats = batch_statistics(weights, cfg, pixels)
    for name, (mean, var) in stats.items():
        weights[f"{name}.running_mean"].copy_(mean)
        weights[f"{name}.running_var"].copy_(var)


def make_pixels(mix: dict, n: int, height: int, width: int,
                gen: torch.Generator, device) -> torch.Tensor:
    """``n`` uint8 NHWC images: a random ``pattern_grid`` of colours,
    bilinearly upsampled, plus uniform noise of ``pattern_noise`` levels
    (white noise alone averages to the same features in every image)."""
    gh, gw = mix["pattern_grid"]
    out = torch.empty((n, height, width, 3), dtype=torch.uint8, device=device)
    for start in range(0, n, 256):
        m = min(256, n - start)
        low = torch.rand(m, 3, gh, gw, generator=gen, device=device) * 255.0
        img = torch.nn.functional.interpolate(
            low, size=(height, width), mode="bilinear", align_corners=False)
        img = img.permute(0, 2, 3, 1) + (torch.rand(
            m, height, width, 3, generator=gen, device=device) - 0.5) * \
            mix["pattern_noise"]
        out[start:start + m] = img.clamp_(0.0, 255.0).round_().to(torch.uint8)
    return out


def make_queues(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The MoCo queues: L2-normalised uniform noise ``[K, D]`` for both
    modalities, identities -1 (empty)."""
    k = cfg["MODEL"]["MOCO"]["K"]
    d = cfg["MODEL"]["EMBEDDING"]["FEATURE_SIZE"]
    gen = _generator(device, seed ^ QUEUE_SALT)
    v = torch.rand(k, d, generator=gen, device=device)
    t = torch.rand(k, d, generator=gen, device=device)
    return {"v": v / v.norm(dim=1, keepdim=True),
            "t": t / t.norm(dim=1, keepdim=True),
            "ids": torch.full((k,), -1, dtype=torch.long, device=device)}


def caption_lengths(mix: dict, n: int, rng) -> np.ndarray:
    """``n`` lengths: the quantiles ``(i + 1/2) / n`` of a lognormal of
    mean ``caption_mean`` and log-sd ``caption_sigma``, rounded and clipped
    to ``[caption_min, caption_max]``, in the seed's order."""
    sigma = mix["caption_sigma"]
    mu = math.log(mix["caption_mean"]) - sigma ** 2 / 2
    normal = NormalDist()
    q = np.array([math.exp(mu + sigma * normal.inv_cdf((i + 0.5) / n))
                  for i in range(n)])
    lengths = np.clip(np.rint(q), mix["caption_min"], mix["caption_max"])
    return rng.permutation(lengths.astype(np.int32))


def token_grid(lengths: np.ndarray, seq: int, vocab: int, rng) -> np.ndarray:
    ids = rng.integers(1, vocab, size=(len(lengths), seq), dtype=np.int64)
    ids[np.arange(seq)[None, :] >= lengths[:, None]] = 0
    return ids


def erase_rects(mix: dict, n: int, height: int, width: int,
                rng) -> np.ndarray:
    """torchvision's RandomErasing rectangles ``[apply, top, left, h, w]``
    (probability, area scale and aspect range from the mix; 10 tries)."""
    out = np.zeros((n, 5), np.int32)
    lo, hi = (math.log(r) for r in mix["erase_ratio"])
    for i in range(n):
        if rng.random() >= mix["erase_prob"]:
            continue
        for _ in range(10):
            area = height * width * rng.uniform(*mix["erase_scale"])
            aspect = math.exp(rng.uniform(lo, hi))
            eh = int(round(math.sqrt(area * aspect)))
            ew = int(round(math.sqrt(area / aspect)))
            if 0 < eh < height and 0 < ew < width:
                out[i] = (1, rng.integers(0, height - eh + 1),
                          rng.integers(0, width - ew + 1), eh, ew)
                break
    return out


def train_ring(mix: dict, cfg: dict, seed: int, device) -> List[dict]:
    """``mix["ring"]`` distinct batches of ``identities_per_batch`` x
    ``images_per_identity`` rows on the device: uint8 NHWC pixels, erase
    rectangles, captions, identities (distinct within a batch)."""
    rows = mix["identities_per_batch"] * mix["images_per_identity"]
    if rows != cfg["SOLVER"]["IMS_PER_BATCH"]:
        raise ValueError(f"the mix's {rows} rows a batch differ from the "
                         f"configuration's {cfg['SOLVER']['IMS_PER_BATCH']}")
    h, w = cfg["INPUT"]["HEIGHT"], cfg["INPUT"]["WIDTH"]
    seq = cfg["INPUT"]["MAX_TEXT_LENGTH"]
    rng = np.random.default_rng(seed)
    n = mix["ring"] * rows
    lengths = caption_lengths(mix, n, rng)
    ids = token_grid(lengths, seq, cfg["MODEL"]["GRU"]["VOCABULARY_SIZE"], rng)
    erase = erase_rects(mix, n, h, w, rng)
    pixels = make_pixels(mix, n, h, w, _generator(device, seed ^ PIXEL_SALT),
                         device)
    ring = []
    for b in range(mix["ring"]):
        rows_of = slice(b * rows, (b + 1) * rows)
        pids = np.repeat(rng.choice(cfg["MODEL"]["NUM_CLASSES"],
                                    mix["identities_per_batch"],
                                    replace=False),
                         mix["images_per_identity"])
        host = {"erase": erase[rows_of], "token_ids": ids[rows_of],
                "lengths": lengths[rows_of], "pids": pids}
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in host.items()}
        batch["pixels"] = pixels[rows_of]
        ring.append(batch)
    return ring


def test_split(mix: dict, cfg: dict, seed: int, device) -> Tuple[list, dict]:
    """A synthetic test split of ``captions`` captions of ``images`` images
    of ``identities`` identities (each image has ``captions // images``
    captions, a few one more), in dataset order, as the test loader
    yields it: batches of ``TEST.IMS_PER_BATCH`` numpy rows, the last
    padded with its last row and marked in ``valid``.  Returns ``(batches,
    split)``, ``split`` holding the rows' ``pids``, ``image_ids``,
    ``lengths`` and ``batch_max`` (the longest caption of each row's
    batch, padding included)."""
    h, w = cfg["INPUT"]["HEIGHT"], cfg["INPUT"]["WIDTH"]
    seq = cfg["INPUT"]["MAX_TEXT_LENGTH"]
    size = cfg["TEST"]["IMS_PER_BATCH"]
    rng = np.random.default_rng(seed)
    n_img, n_cap = mix["images"], mix["captions"]
    image_pid = rng.permutation(np.arange(n_img) % mix["identities"])
    per = np.full(n_img, n_cap // n_img)
    per[rng.choice(n_img, n_cap - per.sum(), replace=False)] += 1
    image_of = np.repeat(np.arange(n_img), per)
    lengths = caption_lengths(mix, n_cap, rng)
    ids = token_grid(lengths, seq, cfg["MODEL"]["GRU"]["VOCABULARY_SIZE"], rng)
    images = make_pixels(mix, n_img, h, w,
                         _generator(device, seed ^ PIXEL_SALT),
                         device).cpu().numpy()
    batches, batch_max = [], np.zeros(n_cap, np.int64)
    for start in range(0, n_cap, size):
        rows = np.arange(start, min(start + size, n_cap))
        valid = np.ones(size, bool)
        valid[len(rows):] = False
        rows = np.concatenate([rows, np.full(size - len(rows), rows[-1])])
        batch_max[rows[valid]] = lengths[rows].max()
        batches.append({"pixels": images[image_of[rows]],
                        "token_ids": ids[rows], "lengths": lengths[rows],
                        "pids": image_pid[image_of[rows]],
                        "image_ids": image_of[rows], "index": rows,
                        "valid": valid})
    split = {"pids": image_pid[image_of], "image_ids": image_of,
             "lengths": lengths, "token_ids": ids, "image_of": image_of,
             "images": images, "batch_max": batch_max}
    return batches, split

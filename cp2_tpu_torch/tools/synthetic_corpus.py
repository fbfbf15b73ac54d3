"""Deterministic synthetic segmentation corpus (shapes-on-texture).

The port's copy of ``tools/make_synthetic_dataset.py`` (which imports only
numpy and PIL, but lives outside the port), for its quality gate
(``cp2_tpu_torch/tools/quality_gate.py``): the same samples bit for bit,
held so by ``tests/test_torch_tools.py``.

It stands in for the polyp datasets (Kvasir-SEG layout: image dir +
binary mask dir with stem-matched PNGs) on hosts with no medical data, so
CP2 pretrain → finetune → test Dice can run end to end through the CLIs.

* fully deterministic (per-index seeds): two hosts generate bit-equal
  corpora;
* not color-separable: foreground blobs reuse the background palette with
  a different spatial frequency and a small offset, so a useful model
  must learn texture/shape, leaving headroom for pretraining to matter;
* polyp-ish geometry: 1-3 smooth star-convex blobs (Fourier-perturbed
  ellipses) per image.

Layout: ``<root>/images/{train,val,test}_<i>.png`` +
``<root>/masks/...``: stems carry the split so both the FILENAME pretrain
discovery and the FILENAME finetune split see the same partition.

Usage: ``python -m cp2_tpu_torch.tools.synthetic_corpus --out DIR --size
160 --n_train 400 --n_val 60 --n_test 80``.  Beside the generator (the
port's own): ``--digests FILE`` writes the sha256 of every image and mask,
file and decoded pixels (``--hash_only`` for a corpus another generator
wrote), and ``--check FILE`` holds a corpus to such a file, as
``chip_smoke.py`` phase 22 does on the card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np
from PIL import Image


def _smooth_noise(rng: np.random.RandomState, size: int, grid: int,
                  channels: int = 3) -> np.ndarray:
    """Low-frequency texture: coarse random grid bilinearly upsampled."""
    coarse = rng.rand(grid, grid, channels).astype(np.float32)
    img = Image.fromarray((coarse * 255).astype(np.uint8))
    return np.asarray(
        img.resize((size, size), Image.BILINEAR), dtype=np.float32
    ) / 255.0


def _blob_mask(rng: np.random.RandomState, size: int) -> np.ndarray:
    """One star-convex blob: ellipse radius modulated by a few Fourier
    harmonics (smooth, polyp-like outline)."""
    cy, cx = rng.uniform(0.25, 0.75, 2) * size
    r0 = rng.uniform(0.10, 0.22) * size
    aspect = rng.uniform(0.6, 1.4)
    theta0 = rng.uniform(0, 2 * np.pi)
    n_harm = 3
    amps = rng.uniform(0.0, 0.18, n_harm)
    phases = rng.uniform(0, 2 * np.pi, n_harm)

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    dy, dx = yy - cy, xx - cx
    # rotate into the ellipse frame
    ry = dy * np.cos(theta0) - dx * np.sin(theta0)
    rx = dy * np.sin(theta0) + dx * np.cos(theta0)
    ang = np.arctan2(ry, rx * aspect)
    rad = np.sqrt((rx * aspect) ** 2 + ry**2)
    r_theta = r0 * (1.0 + sum(
        a * np.sin((k + 2) * ang + p)
        for k, (a, p) in enumerate(zip(amps, phases))
    ))
    return rad <= r_theta


def make_sample(seed: int, size: int) -> tuple:
    rng = np.random.RandomState(seed)
    bg = _smooth_noise(rng, size, grid=rng.randint(4, 8))
    # fine-grained background detail
    bg = np.clip(bg + rng.randn(size, size, 3).astype(np.float32) * 0.04,
                 0, 1)

    mask = np.zeros((size, size), bool)
    n_blobs = rng.randint(1, 4)
    fg = np.zeros_like(bg)
    for _ in range(n_blobs):
        m = _blob_mask(rng, size)
        # foreground texture: same palette family, higher frequency,
        # small brightness offset — learnable but not a color threshold
        tex = _smooth_noise(rng, size, grid=rng.randint(12, 24))
        tex = np.clip(
            0.65 * tex + 0.35 * bg + rng.uniform(-0.12, 0.12, 3), 0, 1
        )
        fg = np.where(m[..., None], tex, fg)
        mask |= m

    img = np.where(mask[..., None], fg, bg)
    img = np.clip(img + rng.randn(size, size, 3).astype(np.float32) * 0.02,
                  0, 1)
    return (img * 255).astype(np.uint8), mask.astype(np.uint8) * 255


def _fold_mask(rng: np.random.RandomState, size: int) -> np.ndarray:
    """Elongated smooth band (mucosal-fold stand-in): a thickened random
    quadratic curve.  Locally its edges look like blob edges."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    theta = rng.uniform(0, np.pi)
    c, s = np.cos(theta), np.sin(theta)
    u = xx * c + yy * s
    v = -xx * s + yy * c
    v0 = rng.uniform(0.15, 0.85)
    a = rng.uniform(-0.8, 0.8)
    b = rng.uniform(-0.5, 0.5)
    width = rng.uniform(0.015, 0.05)
    d = np.abs(v - (v0 + a * (u - 0.5) ** 2 + b * (u - 0.5)))
    return d < width


def make_sample_v2(seed: int, size: int, *, blend: float = 0.40,
                   offset: float = 0.05, distractor_grid=(4, 8),
                   n_distractors=(1, 4)) -> tuple:
    """Corpus v2 — HARD variant (VERDICT r4 next #2).

    v1 saturates: 400 labels train a from-scratch model to Dice 0.93, so
    SSL initialization has no headroom and 5 of 7 quality-gate rows sat
    in a regime the reference's own experiments avoid.  v2 keeps the
    polyp-ish layout but removes the shortcuts, targeting from-scratch
    ratio-1.0 Dice ~0.6-0.75:

    * **low contrast** — target texture blends 60% into the background
      with a tiny brightness offset and a soft alpha edge;
    * **textured distractors** — star-convex blobs filled with
      *background-frequency* texture (unlabeled): "any blob" is no
      longer the answer, the texture frequency cue is;
    * **folds** — elongated curved bands whose edges locally mimic blob
      outlines (shape ambiguity);
    * **occluders/highlights** — specular-like bright streaks crossing
      target and background alike (nuisance lighting, mask unchanged);
    * **illumination gradient** — strong smooth per-image shading, so
      absolute intensity is uninformative.
    """
    rng = np.random.RandomState(seed)
    bg = _smooth_noise(rng, size, grid=rng.randint(4, 8))
    bg = np.clip(bg + rng.randn(size, size, 3).astype(np.float32) * 0.04,
                 0, 1)

    # folds: background structure with blob-like local edges
    for _ in range(rng.randint(1, 4)):
        fm = _fold_mask(rng, size)
        fold_tex = np.clip(bg + rng.uniform(-0.10, 0.10), 0, 1)
        bg = np.where(fm[..., None], fold_tex, bg)

    # textured distractors: same geometry as targets, background-family
    # LOWER-frequency texture (the only reliable target cue is frequency)
    for _ in range(rng.randint(*n_distractors)):
        dm = _blob_mask(rng, size)
        dtex = _smooth_noise(rng, size, grid=rng.randint(*distractor_grid))
        dtex = np.clip(0.5 * dtex + 0.5 * bg + rng.uniform(-offset, offset, 3),
                       0, 1)
        bg = np.where(dm[..., None], dtex, bg)

    mask = np.zeros((size, size), bool)
    img = bg
    for _ in range(rng.randint(1, 3)):
        m = _blob_mask(rng, size)
        tex = _smooth_noise(rng, size, grid=rng.randint(12, 24))
        tex = np.clip(blend * tex + (1 - blend) * bg
                      + rng.uniform(-offset, offset, 3), 0, 1)
        # soft alpha edge: erode-ish feather via distance-free blending of
        # the boolean mask smoothed by a box filter
        mf = m.astype(np.float32)
        k = max(2, size // 53)
        pad = np.pad(mf, k, mode="edge")
        sm = sum(
            pad[dy:dy + size, dx:dx + size]
            for dy in range(0, 2 * k + 1, k)
            for dx in range(0, 2 * k + 1, k)
        ) / 9.0
        alpha = np.clip(sm, 0, 1)[..., None]
        img = img * (1 - alpha) + tex * alpha
        mask |= m

    # specular streaks (over everything, mask unchanged)
    for _ in range(rng.randint(0, 3)):
        hm = _fold_mask(rng, size)
        img = np.where(hm[..., None], np.clip(img + 0.35, 0, 1), img)

    # illumination gradient + vignette
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    gdir = rng.uniform(0, 2 * np.pi)
    grad = (xx - 0.5) * np.cos(gdir) + (yy - 0.5) * np.sin(gdir)
    shade = 1.0 + rng.uniform(0.25, 0.45) * grad
    shade -= rng.uniform(0.1, 0.3) * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2)
    img = np.clip(img * shade[..., None], 0, 1)

    img = np.clip(img + rng.randn(size, size, 3).astype(np.float32) * 0.03,
                  0, 1)
    return (img * 255).astype(np.uint8), mask.astype(np.uint8) * 255


def make_sample_v3(seed: int, size: int) -> tuple:
    """Corpus v3: v2 with the contrast/frequency cues tightened (measured:
    v2 from-scratch ratio-1.0 test Dice 0.804 — still above the 0.6-0.75
    discriminating band VERDICT r4 asks for).  Target texture blends 70%
    into the background with half the brightness offset, and distractor
    texture frequency moves closer to the target band (grid 7-14 vs the
    target's 12-24), with up to 5 distractors."""
    return make_sample_v2(seed, size, blend=0.30, offset=0.03,
                          distractor_grid=(7, 14), n_distractors=(2, 6))


def make_sample_v4(seed: int, size: int) -> tuple:
    """Corpus v4: difficulty interpolation between v2 (measured
    from-scratch ratio-1.0 Dice 0.804) and v3 (0.515), targeting the
    0.6-0.75 discriminating band VERDICT r4 asks for."""
    return make_sample_v2(seed, size, blend=0.35, offset=0.045,
                          distractor_grid=(5, 10), n_distractors=(1, 5))


_SAMPLE_FNS = {1: make_sample, 2: make_sample_v2, 3: make_sample_v3,
               4: make_sample_v4}


def generate(out: str, size: int, counts: dict, seed: int = 0,
             version: int = 1) -> None:
    sample_fn = _SAMPLE_FNS[version]
    img_dir = os.path.join(out, "images")
    mask_dir = os.path.join(out, "masks")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    offsets = {"train": 0, "val": 1_000_000, "test": 2_000_000}
    for split, n in counts.items():
        for i in range(n):
            img, mask = sample_fn(seed + offsets[split] + i, size)
            stem = f"{split}_{i:04d}.png"
            Image.fromarray(img).save(os.path.join(img_dir, stem))
            Image.fromarray(mask).save(os.path.join(mask_dir, stem))


def generate_unlabeled(out: str, size: int, n: int, seed: int = 0,
                       version: int = 1) -> str:
    """Pretrain-only pool: images WITHOUT masks, in a sibling dir.

    Mirrors the reference's pretraining regime — a large unlabeled pool
    disjoint from the labeled finetune set (reference pretrains on the
    full Kvasir/CVC image pools, datasets/pretrain_dataset.py, while the
    finetune split subsamples the labeled set).  Stems carry ``train`` so
    FILENAME pretrain discovery picks them up; the directory is outside
    ``images/`` so the finetune CLIs never see them.
    """
    sample_fn = _SAMPLE_FNS[version]
    un_dir = os.path.join(out, "unlabeled")
    os.makedirs(un_dir, exist_ok=True)
    for i in range(n):
        img, _ = sample_fn(seed + 3_000_000 + i, size)
        Image.fromarray(img).save(
            os.path.join(un_dir, f"train_u{i:05d}.png")
        )
    return un_dir


def digests(root: str) -> dict:
    """``{"images/<name>.png": {"bytes": sha256, "pixels": sha256}, ...}``
    for every PNG under ``<root>/images`` and ``<root>/masks``: the digest of
    the file and of its decoded pixels (shape, dtype and values).  Training
    reads the pixels; the file's bytes also depend on the zlib build that
    encoded them."""
    out = {}
    for sub in ("images", "masks"):
        for name in sorted(os.listdir(os.path.join(root, sub))):
            path = os.path.join(root, sub, name)
            with open(path, "rb") as f:
                raw = f.read()
            with Image.open(path) as im:
                px = np.asarray(im)
            header = f"{px.shape}{px.dtype}".encode()
            out[f"{sub}/{name}"] = {"bytes": hashlib.sha256(raw).hexdigest(),
                                    "pixels": hashlib.sha256(header + px.tobytes()).hexdigest()}
    return out


def compare_digests(root: str, reference: dict, pixels: dict = None) -> dict:
    """``root``'s corpus against a digest file's ``files`` (``reference``):
    the names missing on either side, the files whose decoded pixels
    differ, the files whose bytes differ, and the largest absolute pixel
    difference over the reference arrays in ``pixels`` (``{name: uint8
    array}``, a few files kept whole beside the digests)."""
    ours = digests(root)
    names = sorted(set(ours) | set(reference))
    missing = [n for n in names if n not in ours or n not in reference]
    both = [n for n in names if n in ours and n in reference]
    largest = 0
    for name, want in (pixels or {}).items():
        with Image.open(os.path.join(root, name)) as im:
            got = np.asarray(im).astype(np.int16)
        if got.shape != want.shape:
            raise ValueError(f"{name}: shape {got.shape} against {want.shape}")
        largest = max(largest, int(np.abs(got - want.astype(np.int16)).max()))
    return {"files": len(both), "missing": missing,
            "pixels_differ": [n for n in both if ours[n]["pixels"] != reference[n]["pixels"]],
            "bytes_differ": [n for n in both if ours[n]["bytes"] != reference[n]["bytes"]],
            "largest_pixel_difference": largest}


def write_digests(root: str, path: str, config: dict) -> None:
    """The digest file of ``root`` at ``path`` (JSON: ``config``, the
    ``digests``), and beside it ``<stem>_pixels.npz``: the first image and
    mask of each split kept whole, for the largest pixel difference."""
    kept = {}
    for name in sorted(f"{sub}/{split}_0000.png" for sub in ("images", "masks")
                       for split in ("train", "val", "test")):
        with Image.open(os.path.join(root, name)) as im:
            kept[name] = np.asarray(im)
    stem = os.path.splitext(path)[0]
    np.savez_compressed(stem + "_pixels.npz", **kept)
    with open(path, "w") as f:
        json.dump({"config": config, "pixels": os.path.basename(stem) + "_pixels.npz",
                   "files": digests(root)}, f, indent=0, sort_keys=True)
        f.write("\n")


def load_digests(path: str):
    """``(config, files, pixels)`` of a digest file of ``write_digests``."""
    with open(path) as f:
        doc = json.load(f)
    with np.load(os.path.join(os.path.dirname(path), doc["pixels"])) as z:
        pixels = {name: z[name] for name in z.files}
    return doc["config"], doc["files"], pixels


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=160)
    p.add_argument("--n_train", type=int, default=400)
    p.add_argument("--n_val", type=int, default=60)
    p.add_argument("--n_test", type=int, default=80)
    p.add_argument("--n_unlabeled", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--version", type=int, default=1, choices=(1, 2, 3, 4),
                   help="2 = hard corpus (distractors, low contrast, "
                        "folds, occluders; VERDICT r4 next #2); 3 = "
                        "harder contrast/frequency calibration of 2; 4 = "
                        "difficulty interpolation of 2 and 3 (the gate "
                        "corpus)")
    p.add_argument("--digests", default="",
                   help="write the digest file of --out's images and masks here "
                        "(JSON, with the first file of each split kept whole in an "
                        ".npz beside it)")
    p.add_argument("--hash_only", action="store_true",
                   help="hash a corpus already under --out (another generator's), "
                        "generate nothing")
    p.add_argument("--check", default="",
                   help="compare --out's corpus with this digest file: print the "
                        "differing files and the largest pixel difference, exit 1 on "
                        "any pixel difference")
    args = p.parse_args(argv)
    if args.check:
        _, files, pixels = load_digests(args.check)
        report = compare_digests(args.out, files, pixels)
        print(json.dumps({k: v if isinstance(v, int) else len(v) for k, v in report.items()}))
        return 1 if report["missing"] or report["pixels_differ"] else 0
    if not args.hash_only:
        generate(
            args.out, args.size,
            {"train": args.n_train, "val": args.n_val, "test": args.n_test},
            args.seed, version=args.version,
        )
        if args.n_unlabeled:
            generate_unlabeled(args.out, args.size, args.n_unlabeled, args.seed,
                               version=args.version)
        print(f"wrote {args.n_train}+{args.n_val}+{args.n_test}"
              f"+{args.n_unlabeled}u "
              f"{args.size}x{args.size} v{args.version} samples to {args.out}")
    if args.digests:
        write_digests(args.out, args.digests, {k: getattr(args, k) for k in (
            "size", "n_train", "n_val", "n_test", "seed", "version")})
        print(f"wrote the digests of {args.out} to {args.digests}")


if __name__ == "__main__":
    raise SystemExit(main())

"""MNIST-style 28x28 digit classification data.

Two sources behind one (images, labels) contract:

  - `load_idx(dir)` reads the real MNIST idx files when a local copy exists
    (the reference pulls MNIST through keras, ref
    mnist_with_lenet5.py:36-41; hermetic machines have no egress, so the
    files must be pre-staged).
  - `synthetic(key, n)` procedurally renders digits from glyph bitmaps with
    random shift / amplitude / noise augmentation — a drop-in, fully
    deterministic stand-in that a LeNet5 must still learn conv features
    for. Used by the workload suite and benchmarks.

Both return images in (n, 28, 28, 1) float32 in [0, 1] and int32 labels,
the NHWC layout the models use.
"""
from __future__ import annotations

import gzip
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np

_GLYPHS_TXT = [
    # 8x8 glyphs, '#' = ink
    [
        " ####   ",
        "##  ##  ",
        "##  ##  ",
        "##  ##  ",
        "##  ##  ",
        "##  ##  ",
        " ####   ",
        "        ",
    ],
    [
        "  ##    ",
        " ###    ",
        "  ##    ",
        "  ##    ",
        "  ##    ",
        "  ##    ",
        " ####   ",
        "        ",
    ],
    [
        " ####   ",
        "##  ##  ",
        "    ##  ",
        "   ##   ",
        "  ##    ",
        " ##     ",
        "######  ",
        "        ",
    ],
    [
        " ####   ",
        "##  ##  ",
        "    ##  ",
        "  ###   ",
        "    ##  ",
        "##  ##  ",
        " ####   ",
        "        ",
    ],
    [
        "   ###  ",
        "  ####  ",
        " ## ##  ",
        "##  ##  ",
        "######  ",
        "    ##  ",
        "    ##  ",
        "        ",
    ],
    [
        "######  ",
        "##      ",
        "#####   ",
        "    ##  ",
        "    ##  ",
        "##  ##  ",
        " ####   ",
        "        ",
    ],
    [
        " ####   ",
        "##      ",
        "##      ",
        "#####   ",
        "##  ##  ",
        "##  ##  ",
        " ####   ",
        "        ",
    ],
    [
        "######  ",
        "    ##  ",
        "   ##   ",
        "   ##   ",
        "  ##    ",
        "  ##    ",
        "  ##    ",
        "        ",
    ],
    [
        " ####   ",
        "##  ##  ",
        "##  ##  ",
        " ####   ",
        "##  ##  ",
        "##  ##  ",
        " ####   ",
        "        ",
    ],
    [
        " ####   ",
        "##  ##  ",
        "##  ##  ",
        " #####  ",
        "    ##  ",
        "    ##  ",
        " ####   ",
        "        ",
    ],
]


def _glyph_bank() -> np.ndarray:
    """(10, 24, 24) float glyphs: 8x8 bitmaps upsampled x3 with a soft edge."""
    g = np.array(
        [[[1.0 if c == "#" else 0.0 for c in row] for row in glyph] for glyph in _GLYPHS_TXT],
        dtype=np.float32,
    )
    g = np.repeat(np.repeat(g, 3, axis=1), 3, axis=2)  # (10, 24, 24)
    # soft edges: 3x3 box blur so augmentation shifts create sub-ink gradients
    k = np.ones((3, 3), np.float32) / 9.0
    out = np.zeros_like(g)
    padded = np.pad(g, ((0, 0), (1, 1), (1, 1)))
    for dy in range(3):
        for dx in range(3):
            out += k[dy, dx] * padded[:, dy : dy + 24, dx : dx + 24]
    return out


_BANK = jnp.asarray(np.pad(_glyph_bank(), ((0, 0), (2, 2), (2, 2))))  # (10, 28, 28)


def synthetic(
    key: jax.Array, n: int, dtype=jnp.float32
) -> tuple[jax.Array, jax.Array]:
    """n augmented digit images: random shift (±3 px), contrast, noise."""
    k_lab, k_dy, k_dx, k_amp, k_noise = jax.random.split(key, 5)
    labels = jax.random.randint(k_lab, (n,), 0, 10)
    imgs = _BANK[labels]  # (n, 28, 28)
    dy = jax.random.randint(k_dy, (n,), -3, 4)
    dx = jax.random.randint(k_dx, (n,), -3, 4)
    # static-shape batched shift: roll via gather on shifted indices
    rows = (jnp.arange(28)[None, :] - dy[:, None]) % 28
    cols = (jnp.arange(28)[None, :] - dx[:, None]) % 28
    imgs = jax.vmap(lambda im, r, c: im[r][:, c])(imgs, rows, cols)
    amp = jax.random.uniform(k_amp, (n, 1, 1), minval=0.7, maxval=1.0)
    noise = 0.08 * jax.random.normal(k_noise, imgs.shape)
    imgs = jnp.clip(amp * imgs + noise, 0.0, 1.0).astype(dtype)
    return imgs[..., None], labels.astype(jnp.int32)


def synthetic_hard(
    key: jax.Array, n: int, dtype=jnp.float32
) -> tuple[jax.Array, jax.Array]:
    """Hardened procedural digits: full per-sample affine distortion
    (rotation ±28deg, shear, scale 0.75-1.3, continuous sub-pixel shift),
    stroke-thickness variation (gamma), contrast, a background intensity
    ramp, heavy noise, and occasional occlusion bars.

    Purpose (VERDICT r1): the easy `synthetic` set reaches 0.0% LeNet5
    error, so quality criteria built on it cannot fail. This set leaves
    LeNet5 at a measurably non-zero error plateau (extreme-augmentation
    samples are genuinely ambiguous), making matched-error targets
    discriminating. No real-MNIST idx files exist on a hermetic host —
    `load_idx` below stays the real-data path when staged.
    """
    ks = jax.random.split(key, 12)
    labels = jax.random.randint(ks[0], (n,), 0, 10)
    imgs = _BANK[labels]  # (n, 28, 28)

    # per-sample inverse affine: rotate, shear, scale about the center
    ang = jax.random.uniform(ks[1], (n,), minval=-0.5, maxval=0.5)
    shear = jax.random.uniform(ks[2], (n,), minval=-0.3, maxval=0.3)
    scale = jax.random.uniform(ks[3], (n,), minval=0.75, maxval=1.3)
    dy = jax.random.uniform(ks[4], (n,), minval=-3.5, maxval=3.5)
    dx = jax.random.uniform(ks[5], (n,), minval=-3.5, maxval=3.5)
    c, s = jnp.cos(ang), jnp.sin(ang)
    # forward map F = scale * R(ang) @ Shear; sample at F^{-1} (output->src)
    f00, f01 = scale * c, scale * (c * shear - s)
    f10, f11 = scale * s, scale * (s * shear + c)
    det = f00 * f11 - f01 * f10
    i00, i01 = f11 / det, -f01 / det
    i10, i11 = -f10 / det, f00 / det

    yy, xx = jnp.mgrid[0:28, 0:28]
    yy = yy.astype(jnp.float32) - 13.5
    xx = xx.astype(jnp.float32) - 13.5
    sy = i00[:, None, None] * yy + i01[:, None, None] * xx + 13.5 - dy[:, None, None]
    sx = i10[:, None, None] * yy + i11[:, None, None] * xx + 13.5 - dx[:, None, None]

    # bilinear sample with zero outside
    y0 = jnp.floor(sy).astype(jnp.int32)
    x0 = jnp.floor(sx).astype(jnp.int32)
    wy = sy - y0
    wx = sx - x0

    def tap(img, yi, xi):
        valid = (yi >= 0) & (yi < 28) & (xi >= 0) & (xi < 28)
        vals = img[jnp.clip(yi, 0, 27), jnp.clip(xi, 0, 27)]
        return jnp.where(valid, vals, 0.0)

    def warp(img, y0, x0, wy, wx):
        return (
            tap(img, y0, x0) * (1 - wy) * (1 - wx)
            + tap(img, y0, x0 + 1) * (1 - wy) * wx
            + tap(img, y0 + 1, x0) * wy * (1 - wx)
            + tap(img, y0 + 1, x0 + 1) * wy * wx
        )

    imgs = jax.vmap(warp)(imgs, y0, x0, wy, wx)

    # stroke thickness via gamma on the soft-edged ink
    gamma = jax.random.uniform(ks[6], (n, 1, 1), minval=0.55, maxval=2.0)
    imgs = jnp.clip(imgs, 0.0, 1.0) ** gamma

    # contrast + background ramp + noise
    amp = jax.random.uniform(ks[7], (n, 1, 1), minval=0.5, maxval=1.0)
    gy = jax.random.uniform(ks[8], (n, 1, 1), minval=-0.15, maxval=0.15)
    gx = jax.random.uniform(ks[9], (n, 1, 1), minval=-0.15, maxval=0.15)
    ramp = gy * (yy / 14.0) + gx * (xx / 14.0)
    sigma = jax.random.uniform(ks[10], (n, 1, 1), minval=0.08, maxval=0.22)
    noise = sigma * jax.random.normal(ks[11], imgs.shape)

    # occlusion bar: a 4-px strip dimmed to 20%, ~30% of samples
    kb1, kb2, kb3 = jax.random.split(ks[0], 3)
    pos = jax.random.randint(kb1, (n, 1, 1), 4, 24)
    horiz = jax.random.bernoulli(kb2, 0.5, (n, 1, 1))
    occlude = jax.random.bernoulli(kb3, 0.3, (n, 1, 1))
    coord = jnp.where(horiz, yy[None], xx[None]) + 13.5
    bar = (coord >= pos) & (coord < pos + 4) & occlude
    imgs = jnp.where(bar, 0.2 * imgs, imgs)

    imgs = jnp.clip(amp * imgs + ramp + noise, 0.0, 1.0).astype(dtype)
    return imgs[..., None], labels.astype(jnp.int32)


def load_idx(data_dir: str) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read pre-staged MNIST idx(.gz) files: returns (x_train, y_train,
    x_test, y_test) with images (n, 28, 28, 1) float32 in [0, 1].

    Uses the native C++ decoder (data/native.py) when the toolchain is
    available; the pure-Python path below is the fallback and oracle."""
    from psgd_tf_tpu.data import native

    if native.available():
        def pair(img_name, lab_name):
            x = native.decode_idx_images(os.path.join(data_dir, img_name))
            y = native.decode_idx_labels(os.path.join(data_dir, lab_name))
            return x.reshape(-1, 28, 28, 1), y

        try:
            xtr, ytr = pair("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
            xte, yte = pair("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
            return xtr, ytr, xte, yte
        except (FileNotFoundError, ValueError):
            pass  # fall through to the Python path's richer error handling

    def _open(name):
        for fname in (name, name + ".gz"):
            path = os.path.join(data_dir, fname)
            if os.path.exists(path):
                return gzip.open(path, "rb") if fname.endswith(".gz") else open(path, "rb")
        raise FileNotFoundError(f"{name}[.gz] not in {data_dir}")

    def _images(name):
        with _open(name) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            assert magic == 2051, f"bad idx magic {magic}"
            buf = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
        return (buf.reshape(n, rows, cols, 1) / 255.0).astype(np.float32)

    def _labels(name):
        with _open(name) as f:
            magic, n = struct.unpack(">II", f.read(8))
            assert magic == 2049, f"bad idx magic {magic}"
            return np.frombuffer(f.read(n), dtype=np.uint8).astype(np.int32)

    return (
        _images("train-images-idx3-ubyte"),
        _labels("train-labels-idx1-ubyte"),
        _images("t10k-images-idx3-ubyte"),
        _labels("t10k-labels-idx1-ubyte"),
    )

"""Modality frontend stubs of the audio and vision archs (port of
`repro.models.frontends`, numpy only).

  * whisper: a waveform becomes 1500 frame embeddings (30 s at 50 frames a
    second) through crude energy features and a fixed seeded projection
    standing in for the log-mel filterbank and the two conv1d layers; the
    encoder reads them;
  * llava-next: 2880 image-embedding rows (anyres: 5 tiles of 24 x 24
    patches), prepended to the prompt, from an image through a fixed seeded
    projection standing in for the vision tower and its projector.

Both are deterministic and shape-faithful, not trained towers. The numpy
arithmetic is the JAX package's step for step, so the rows are bitwise its
stubs'.
"""

from __future__ import annotations

import numpy as np
import torch

WHISPER_FRAMES = 1500        # 30 s at 50 fps after the conv stride-2
LLAVA_TILES = 5              # anyres: 4 crops + 1 downscaled overview
LLAVA_PATCHES_PER_TILE = 576  # 24 x 24 at patch 14 on 336px tiles


def _fixed_projection(seed: int, d_in: int, d_out: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, d_in, d_out]))
    return (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(
        np.float32)


def whisper_frames(waveform: np.ndarray, d_model: int, n_mels: int = 128,
                   device="cuda") -> torch.Tensor:
    """waveform: (B, T) float. Returns (B, 1500, d_model) f32 frame
    embeddings on `device`: each frame's hop of samples gives 4 energy
    features (mean log1p |x|, std, max, min), each repeated n_mels / 4
    times, through the fixed projection."""
    b, t = waveform.shape
    hop = max(1, t // WHISPER_FRAMES)
    frames = waveform[:, :hop * WHISPER_FRAMES].reshape(
        b, WHISPER_FRAMES, hop)
    feats = np.stack([
        np.log1p(np.abs(frames)).mean(-1),
        frames.std(-1),
        frames.max(-1),
        frames.min(-1),
    ], axis=-1).astype(np.float32)                       # (B, 1500, 4)
    feats = np.repeat(feats, n_mels // 4, axis=-1)       # (B, 1500, n_mels)
    proj = _fixed_projection(0xA0D10, n_mels, d_model)
    return torch.from_numpy(np.ascontiguousarray(feats @ proj)).to(device)


def llava_patches(image: np.ndarray, d_model: int,
                  device="cuda") -> torch.Tensor:
    """image: (B, H, W, 3) float in [0, 1]. Returns (B, 2880, d_model) f32
    embeddings on `device`.

    Anyres tiling is simulated: the image is cut into 5 tiles (the four
    quadrants, then the whole image), each strided into a 24 x 24 patch
    grid; a patch's mean colour, its grid position and the tile index form
    the feature vector fed to the fixed projection."""
    b, h, w, _ = image.shape
    grid = 24
    feats = []
    for tile in range(LLAVA_TILES):
        if tile < 4:
            ys = slice((tile // 2) * h // 2, (tile // 2 + 1) * h // 2)
            xs = slice((tile % 2) * w // 2, (tile % 2 + 1) * w // 2)
            sub = image[:, ys, xs]
        else:
            sub = image
        sh, sw = sub.shape[1] // grid, sub.shape[2] // grid
        sub = sub[:, :sh * grid, :sw * grid]
        patches = sub.reshape(b, grid, sh, grid, sw, 3).mean((2, 4))
        pos = np.stack(np.meshgrid(np.linspace(0, 1, grid),
                                   np.linspace(0, 1, grid),
                                   indexing="ij"), -1)
        f = np.concatenate([patches,
                            np.broadcast_to(pos, (b, grid, grid, 2)),
                            np.full((b, grid, grid, 1), tile / 4.0)], -1)
        feats.append(f.reshape(b, grid * grid, 6))
    feats = np.concatenate(feats, axis=1).astype(np.float32)  # (B, 2880, 6)
    proj = _fixed_projection(0x11A7A, 6, d_model)
    return torch.from_numpy(np.ascontiguousarray(feats @ proj)).to(device)

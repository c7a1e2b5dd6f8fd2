"""Deterministic, step-indexable synthetic LM data (a copy of
`repro.data.pipeline`, which is plain numpy: the port keeps its own).

`batch(step)` is a pure function of (seed, step), bit for bit the JAX
package's: a job restarted from a step-N checkpoint consumes exactly the
batches it would have seen had it never failed. No filesystem state, no
iterator position to persist. Batches come out as numpy; the training
loop moves them to the device.

Two sources:
  * 'markov'  — a seeded random bigram machine with noise: the next token
    is a fixed function of the previous one with prob (1 - noise), so a
    model can learn it (loss -> about the noise's entropy);
  * 'uniform' — i.i.d. tokens (irreducible loss ln V).

Multimodal stubs: whisper frames and llava image embeddings are seeded
gaussians of the right shapes (`frames`, `img_embeds`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    source: str = "markov"          # 'markov' | 'uniform'
    noise: float = 0.1
    # multimodal stubs
    frames: int = 0                 # whisper encoder positions
    d_model: int = 0
    img_tokens: int = 0             # llava vision tokens


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0xDA7A]))
        # fixed bigram successor table
        self._succ = rng.integers(0, cfg.vocab, size=(cfg.vocab,),
                                  dtype=np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, 0xBA7C4, int(step)]))
        b, s, v = cfg.batch, cfg.seq, cfg.vocab
        if cfg.source == "uniform":
            seq = rng.integers(0, v, size=(b, s + 1), dtype=np.int32)
        else:
            seq = np.empty((b, s + 1), np.int32)
            seq[:, 0] = rng.integers(0, v, size=(b,))
            noise_mask = rng.random((b, s)) < cfg.noise
            noise_tok = rng.integers(0, v, size=(b, s), dtype=np.int32)
            for t in range(1, s + 1):
                nxt = self._succ[seq[:, t - 1]]
                seq[:, t] = np.where(noise_mask[:, t - 1], noise_tok[:, t - 1],
                                     nxt)
        out = {
            "tokens": seq[:, :-1],
            "labels": seq[:, 1:].astype(np.int32),
        }
        if cfg.frames:
            out["frames"] = rng.standard_normal(
                (b, cfg.frames, cfg.d_model)).astype(np.float32) * 0.1
        if cfg.img_tokens:
            out["img_embeds"] = rng.standard_normal(
                (b, cfg.img_tokens, cfg.d_model)).astype(np.float32) * 0.1
        return out


def make_pipeline(cfg: DataConfig) -> SyntheticLM:
    return SyntheticLM(cfg)

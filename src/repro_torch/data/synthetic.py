"""Deterministic, checkpointable synthetic data pipeline.

Restart correctness (paper §3.4: "resume the application threads" with no
data loss/duplication) requires the input pipeline's cursor to live inside
the checkpoint. Batches here are a pure function of (seed, step): the
pipeline state is two integers, the restore path replays neither data nor
RNG, and a restored run is bitwise-identical to an uninterrupted one
(asserted by tests/test_torch_restart.py).

Token streams follow a Zipfian-ish distribution (more realistic compression
behaviour for the Table-2/3 benchmarks than uniform noise).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


class SyntheticBatches:
    def __init__(
        self,
        cfg: ModelConfig,
        *,
        batch: int,
        seq_len: int,
        seed: int = 0,
        start_step: int = 0,
    ):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.step = start_step

    # -- checkpointable state ----------------------------------------------------
    def state(self) -> dict:
        return {"seed": np.int64(self.seed), "step": np.int64(self.step)}

    @classmethod
    def from_state(cls, cfg: ModelConfig, *, batch: int, seq_len: int, state: dict):
        return cls(
            cfg, batch=batch, seq_len=seq_len,
            seed=int(np.asarray(state["seed"])),
            start_step=int(np.asarray(state["step"])),
        )

    # -- generation ---------------------------------------------------------------
    def _tokens(self, rng: np.random.Generator, shape) -> np.ndarray:
        v = self.cfg.vocab_size
        z = rng.zipf(1.3, size=shape).astype(np.int64)
        return ((z - 1) % v).astype(np.int32)

    def _batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.PCG64(np.random.SeedSequence([self.seed, step]))
        )
        cfg = self.cfg
        B, S = self.batch, self.seq_len
        if cfg.frontend == "audio":
            toks = self._tokens(rng, (B, S + 1, cfg.audio_codebooks))
            return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        out = {}
        toks = self._tokens(rng, (B, S + 1))
        out["inputs"], out["targets"] = toks[:, :-1], toks[:, 1:]
        if cfg.frontend == "vision":
            out["patches"] = rng.standard_normal(
                (B, cfg.num_patches, cfg.d_model), dtype=np.float32
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self._batch_at(self.step)
        self.step += 1
        return b

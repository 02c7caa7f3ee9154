"""Deterministic, shardable synthetic token pipeline.

The port's copy of ``repro.data.pipeline``: NumPy only, so batches are
bit-identical to the JAX package's for the same ``(seed, step, host)``.
``make_batch_specs`` gives ``(shape, dtype)`` pairs (torch dtypes for
the float inputs) where the JAX package gives ``jax.ShapeDtypeStruct``s.

Design constraints for 1000+-node training:

* **Determinism** — batch ``step`` is a pure function of ``(seed, step)``;
  any host can regenerate any shard of any step.  This is what makes
  checkpoint-restart and *elastic rescale* trivial: after a failure the
  surviving hosts recompute their (new) shard of the same step stream —
  no data-state checkpoint is needed.
* **Host sharding** — each host materializes only ``global_batch /
  n_hosts`` rows (``host_slice``).
* **Prefetch** — a background thread keeps ``prefetch`` batches ready so
  step N+1's host work overlaps step N's device work (the paper's
  latency-hiding invariant applied to the input pipeline).

The token stream is a mixture of Zipf-distributed unigrams with a
repeating-ngram structure so the LM loss actually decreases during the
example runs (pure-uniform tokens give a flat loss).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "TokenPipeline", "make_batch_specs"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2  # unigram skew
    ngram: int = 8  # repeated-motif length (gives the model signal)
    n_motifs: int = 512


class TokenPipeline:
    """Iterator of ``{"tokens": [b, S], "labels": [b, S]}`` host shards."""

    def __init__(
        self,
        cfg: DataConfig,
        *,
        host_id: int = 0,
        n_hosts: int = 1,
        prefetch: int = 2,
    ):
        if cfg.global_batch % n_hosts:
            raise ValueError("global_batch must divide by n_hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        self._motifs = self._make_motifs()
        self._q: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self._prefetch = prefetch
        self._thread: Optional[threading.Thread] = None
        self._next_step = 0

    # -- deterministic generation -----------------------------------------
    def _make_motifs(self) -> np.ndarray:
        rng = np.random.default_rng(self.cfg.seed ^ 0x5F5E5F5)
        V = self.cfg.vocab_size
        # Zipf-ish unigram table (bounded)
        ranks = np.arange(1, V + 1, dtype=np.float64)
        probs = ranks ** (-self.cfg.zipf_a)
        probs /= probs.sum()
        return rng.choice(V, size=(self.cfg.n_motifs, self.cfg.ngram), p=probs)

    def batch_at(self, step: int, *, host_id: Optional[int] = None) -> dict:
        """Pure function of (seed, step, host) → the host's batch shard."""
        host = self.host_id if host_id is None else host_id
        c = self.cfg
        rng = np.random.default_rng((c.seed, step, host))
        b = self.local_batch
        n_slots = c.seq_len // c.ngram + 1
        ids = rng.integers(0, c.n_motifs, size=(b, n_slots))
        toks = self._motifs[ids].reshape(b, -1)[:, : c.seq_len + 1]
        # sprinkle noise tokens so the task is not pure memorization
        noise = rng.random((b, c.seq_len + 1)) < 0.05
        toks = np.where(
            noise, rng.integers(0, c.vocab_size, size=toks.shape), toks
        ).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    # -- prefetching iterator ----------------------------------------------
    def _worker(self):
        while not self._stop.is_set():
            batch = self.batch_at(self._next_step)
            self._next_step += 1
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[dict]:
        self._q = queue.Queue(maxsize=self._prefetch)
        self._stop.clear()
        self._next_step = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        try:
            while True:
                yield self._q.get()
        finally:
            self.close()

    def close(self):
        self._stop.set()
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass

    # -- elastic rescale -----------------------------------------------------
    def rescale(self, host_id: int, n_hosts: int) -> "TokenPipeline":
        """Return a pipeline for the new host set (node loss/join).  The
        step→data mapping is preserved because generation is pure."""
        return TokenPipeline(
            self.cfg, host_id=host_id, n_hosts=n_hosts, prefetch=self._prefetch
        )


def make_batch_specs(cfg, shape, *, np_dtype=np.int32) -> dict:
    """``(shape, dtype)`` stand-ins for one *global* batch of this model
    config × shape cell (no allocation): token ids in ``np_dtype``, the
    encoder frames and image embeddings in ``cfg.tdtype``."""
    B, S = shape.global_batch, shape.seq_len
    specs = {}
    if shape.kind == "train" or shape.kind == "prefill":
        S_text = S
        if cfg.n_img_tokens:
            S_text = S - cfg.n_img_tokens  # image tokens occupy the prefix
        specs["tokens"] = ((B, S_text), np.dtype(np_dtype))
        if shape.kind == "train":
            specs["labels"] = ((B, S_text), np.dtype(np_dtype))
        if cfg.enc_dec:
            specs["enc_frames"] = ((B, cfg.enc_seq, cfg.d_model), cfg.tdtype)
        if cfg.n_img_tokens:
            specs["img_emb"] = ((B, cfg.n_img_tokens, cfg.d_model), cfg.tdtype)
    else:  # decode: one new token against a seq_len-deep cache
        specs["tokens"] = ((B,), np.dtype(np_dtype))
    return specs

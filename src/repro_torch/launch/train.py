"""Training driver: data pipeline → train_step → checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-3-4b \
        --reduced --steps 200 --ckpt-dir /tmp/ckpt --device cpu

The port of ``repro.launch.train``, with the same flags plus
``--device``: the model trains on the GPU unless ``--device cpu`` is
given (``cpu`` runs only when asked; without a GPU the default raises).
Checkpoints hold ``(params, opt_state)`` in the JAX package's parameter
layout (``repro_torch.checkpoint.store.model_tree``), so either package
resumes the other's run.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.store import model_tree
from repro_torch.configs import get_config, get_reduced
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import init_params
from repro_torch.models.layers import resolve_device
from repro_torch.optim import AdamW, OptState, linear_warmup_cosine

from .steps import make_train_step

__all__ = ["train", "train_state_tree", "batch_to_device"]


def train_state_tree(params, opt_state: OptState):
    """``(params, opt_state)`` as the checkpoint tree: the parameters and
    both moments in the JAX package's layout, the step as it is."""
    return (model_tree(dict(params.named_parameters())),
            OptState(opt_state.step, model_tree(opt_state.mu), model_tree(opt_state.nu)))


def batch_to_device(cfg, batch: dict, device) -> dict:
    """The pipeline's host batch on ``device``, with the zero encoder
    frames or image embeddings that the driver feeds an encoder-decoder
    or a VLM (as the JAX package's driver does)."""
    device = resolve_device(device)
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    B = batch["tokens"].shape[0]
    if cfg.enc_dec:
        out["enc_frames"] = torch.zeros((B, cfg.enc_seq, cfg.d_model), dtype=cfg.tdtype,
                                        device=device)
    if cfg.n_img_tokens:
        out["img_emb"] = torch.zeros((B, cfg.n_img_tokens, cfg.d_model), dtype=cfg.tdtype,
                                     device=device)
    return out


def train(
    arch: str,
    *,
    reduced: bool = True,
    steps: int = 200,
    seq_len: int = 128,
    global_batch: int = 8,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    lr: float = 1e-3,
    log_every: int = 10,
    resume: bool = False,
    device=None,
):
    device = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    cfg = cfg.replace(microbatches=1)
    params = init_params(cfg, 0, device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[train] {arch} reduced={reduced} params={n_params/1e6:.1f}M device={device}")

    opt = AdamW(
        lr=linear_warmup_cosine(lr, warmup=max(1, steps // 20), total_steps=steps),
        moment_dtype=cfg.opt_state_dtype,
    )
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)

    pipe = TokenPipeline(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch)
    )
    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    start = 0
    if mgr and resume and mgr.latest_step() is not None:
        _, start = mgr.restore(train_state_tree(params, opt_state))  # in place
        print(f"[train] resumed from step {start}")

    t0 = time.time()
    losses = []
    for step in range(start, steps):
        batch = batch_to_device(cfg, pipe.batch_at(step), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % log_every == 0 or step == steps - 1:
            dt = time.time() - t0
            tps = (step - start + 1) * global_batch * seq_len / max(dt, 1e-9)
            print(f"  step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} tok/s {tps:,.0f}")
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, train_state_tree(params, opt_state))  # async
    if mgr and steps % ckpt_every:
        mgr.save(steps, train_state_tree(params, opt_state), blocking=True)
    elif mgr:  # the loop saved this step already (the JAX package's driver
        mgr.wait()  # saves it twice, and the second commit fails)
    if losses:
        print(f"[train] done: loss {losses[0]:.3f} → {losses[-1]:.3f} "
              f"({time.time()-t0:.0f}s)")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' only when asked)")
    a = ap.parse_args(argv)
    train(a.arch, reduced=a.reduced, steps=a.steps, seq_len=a.seq_len,
          global_batch=a.global_batch, ckpt_dir=a.ckpt_dir,
          ckpt_every=a.ckpt_every, lr=a.lr, resume=a.resume, device=a.device)


if __name__ == "__main__":
    main()

"""Training entry point of the port: data pipeline -> supervised train step
-> checkpoints (counterpart of ``repro.launch.train``).

Takes the reference launcher's flags with its defaults, plus
``--device`` (``cuda`` by default, which raises without a card; ``cpu``
runs the plain PyTorch path), and prints the same lines and the same
final JSON:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 30 --scale tiny --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 5 --scale full --ckpt-dir /tmp/ckpt

``--scale full`` trains the published config (gemma2-2b: 2.6 B params,
about 31 GB of params, grads and AdamW moments on one H100).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import base as cfgs
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.dist.fault import FaultConfig, Supervisor
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.optimizer import OptConfig

ARCH_NAMES = tuple(a for a in cfgs.PORTED if a != "reactnet")

TINY_OVERRIDES = dict(
    num_layers=2, scan_repeats=2, prefix_kinds=(), suffix_kinds=(),
    d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
    vocab_size=512, dtype="float32", window=64,
)


def tiny_config(arch: str):
    """The reference's ``--scale tiny`` config of ``arch``."""
    cfg = cfgs.get_config(arch)
    over = dict(TINY_OVERRIDES)
    if cfg.family == "ssm":
        over.update(num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
                    ssm_heads=4, ssm_state=16, ssm_chunk=32, expand=2)
    if cfg.family == "moe":
        over.update(num_experts=4, top_k=2, moe_d_ff=128,
                    num_shared_experts=min(1, cfg.num_shared_experts))
        if cfg.prefix_kinds:
            over.update(prefix_kinds=cfg.prefix_kinds[:1], scan_repeats=1,
                        num_layers=2)
        if cfg.kv_lora_rank:
            over.update(num_kv_heads=4, kv_lora_rank=32, q_lora_rank=48,
                        rope_head_dim=16, nope_head_dim=32, v_head_dim=32)
    if cfg.family == "hybrid":
        over.update(scan_repeats=1, suffix_kinds=("rglru",), num_layers=4,
                    lru_width=128, num_kv_heads=1)
    if cfg.family == "vlm":
        over.update(num_vision_tokens=8, num_kv_heads=1)
    if cfg.family == "audio":
        over.update(encoder_layers=2, encoder_seq=32, num_kv_heads=4)
    if cfg.scan_pattern and len(cfg.scan_pattern) > 1:
        # one repeat of a multi-kind pattern (gemma2: local + global)
        over.update(scan_repeats=max(1, over["num_layers"]
                                     // len(cfg.scan_pattern)))
        over["num_layers"] = over["scan_repeats"] * len(cfg.scan_pattern) \
            + len(over.get("suffix_kinds", ()))
    return cfg.scaled(**over)


def to_batch(cfg, arrays: dict, device) -> dict:
    """A pipeline batch (numpy) -> tensors on ``device``, with the zero
    vision or frame embeddings of the stubbed frontends."""
    batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    b = arrays["tokens"].shape[0]
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.zeros(
            (b, cfg.num_vision_tokens, cfg.d_model), dtype=cfg.torch_dtype,
            device=device)
    if cfg.family == "audio":
        batch["frame_embeds"] = torch.zeros(
            (b, cfg.encoder_seq, cfg.d_model), dtype=cfg.torch_dtype,
            device=device)
    return batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--scale", choices=["tiny", "full"], default="tiny")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (needs a card) or cpu (the plain PyTorch "
                         "path)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = tiny_config(args.arch) if args.scale == "tiny" \
        else cfgs.get_config(args.arch)
    started = not dist.is_initialized()
    mesh = make_host_mesh(device=device)
    try:
        return _train(args, cfg, mesh, device)
    finally:
        if started:                     # the world of one it started
            dist.destroy_process_group()


def _train(args, cfg, mesh, device) -> list:
    oc = OptConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)

    step_fn, _ = steps_mod.build_train_step(cfg, mesh, oc)
    state = steps_mod.init_train_state(
        cfg, mesh, torch.Generator(device).manual_seed(0), device=device)

    sup = Supervisor(FaultConfig(ckpt_dir=args.ckpt_dir,
                                 ckpt_every=args.ckpt_every))
    state, start = sup.maybe_restore(state)

    data = SyntheticLM(cfg.vocab_size, args.batch, args.seq)
    pf = Prefetcher(data, start_step=start)
    losses = []
    t0 = time.monotonic()
    try:
        for step in range(start, args.steps):
            batch = to_batch(cfg, next(pf), device)
            state, report = sup.run_step(step_fn, state, batch, step)
            losses.append(report.loss)
            sup.maybe_save(state, step)
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.monotonic() - t0
                print(f"step {step:5d} loss {report.loss:8.4f} "
                      f"({dt / max(step - start + 1, 1):.2f}s/step)",
                      flush=True)
    finally:
        pf.close()
    sup.finalize(state, args.steps)
    head = float(np.mean(losses[:10]))
    tail = float(np.mean(losses[-10:]))
    print(json.dumps({"first10_loss": head, "last10_loss": tail,
                      "events": sup.events[-5:]}))
    if args.steps >= 100:
        assert tail < head, "training did not reduce loss"
    return losses


if __name__ == "__main__":
    main()

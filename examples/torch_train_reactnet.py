"""The paper's full BNN workflow on the PyTorch/CUDA port (counterpart of
``examples/train_reactnet.py``): train a ReActNet on the synthetic image
task, compress the trained kernels, and validate the compressed model.

train (fp latent weights + STE) -> offline frequency analysis ->
clustering + Huffman -> deploy through the fused decode kernel ->
accuracy of the three paths and the compression report -> compressed
checkpoint.

On the card (the default) the deploy step runs the port's hand-written
kernels: the patch and row packs, the xnor-popcount contraction and the
fused Huffman-decode contraction.  ``--device cpu`` runs their plain
PyTorch versions.

Run:  PYTHONPATH=src python examples/torch_train_reactnet.py [--steps 150]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import bitpack, compression, frequency
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.models import reactnet as rn
from repro_torch.train import optimizer as opt

# the reference example's model: ReActNet blocks at width 32 on 32x32
# images of 10 classes
CONFIG = dataclasses.replace(rn.CONFIG, width=32, num_classes=10,
                             image_size=32,
                             blocks=((2, 1), (1, 2), (2, 2), (1, 1)))
TEST_STEP = 10_001          # the data step of the held-out batch


def opt_config(steps: int) -> opt.OptConfig:
    return opt.OptConfig(lr=2e-2, warmup_steps=10, total_steps=steps,
                         weight_decay=1e-4, clip_latent=1.5)


def _to(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train(cfg, params, oc: opt.OptConfig, data, steps: int, device,
          log=print):
    """``steps`` AdamW steps in ``ste`` mode from ``params``; returns the
    trained params and the loss of every step."""
    state = opt.init_state(params)
    losses = []
    for i in range(steps):
        loss, grads = rn.loss_and_grads(cfg, params, _to(data.batch(i),
                                                         device))
        params, state, _ = opt.apply_updates(params, grads, state, oc)
        losses.append(loss)
        if i % 25 == 0 or i == steps - 1:
            log(f"step {i:4d}  loss {float(loss):.4f}")
    return params, [float(x) for x in losses]


def deploy(cfg, params, images: torch.Tensor) -> dict:
    """Logits of the float-sign (``ste``) path and of the compressed path
    without and with clustering."""
    cfg_c = dataclasses.replace(cfg, conv_mode="compressed")
    with torch.no_grad():
        return {
            "ste": rn.forward(cfg, params, images),
            "compressed": rn.forward(
                cfg_c, params, images,
                compressed=rn.prepare_compressed(params, cluster=False)),
            "clustered": rn.forward(
                cfg_c, params, images,
                compressed=rn.prepare_compressed(params, cluster=True)),
        }


def workflow(steps: int = 150, batch: int = 32, device="cuda",
             ckpt_dir: str = "", log=print) -> dict:
    """Train, deploy, report and (with ``ckpt_dir``) checkpoint; returns
    what it measured."""
    device = resolve_device(device)
    if device.type == "cuda":
        # exact integer sums in the ste path's float GEMMs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = CONFIG
    params = rn.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                            device)
    data = SyntheticImages(cfg.num_classes, cfg.image_size, batch)
    params, losses = train(cfg, params, opt_config(steps), data, steps,
                           device, log)

    # --- accuracy of the three deployment paths ---------------------------
    test = data.batch(TEST_STEP)
    logits = deploy(cfg, params, torch.from_numpy(test["images"]).to(device))
    preds = {k: v.argmax(-1).cpu().numpy() for k, v in logits.items()}
    acc = {k: float((p == test["labels"]).mean()) for k, p in preds.items()}
    log(f"accuracy  float-sign: {acc['ste']:.3f}   compressed: "
        f"{acc['compressed']:.3f}   compressed+clustered: "
        f"{acc['clustered']:.3f}")
    if abs(acc["ste"] - acc["compressed"]) >= 1e-6:
        raise AssertionError("lossless path must match exactly")

    # --- compression report (paper Table V / model ratio) ------------------
    bits = rn.binary_weight_bits(params)
    w3 = {k: v for k, v in bits.items() if k.endswith("w3")}
    cts, rep = compression.compress_model(w3, fp_bits=rn.fp_bits(cfg,
                                                                 params))
    log(f"binary-kernel ratio {rep.binary_ratio:.3f}x   "
        f"model ratio {rep.model_ratio:.3f}x")
    top64 = {}
    for name, w in w3.items():
        h = frequency.sequence_histogram(bitpack.kernel_to_sequences(w))
        top64[name] = frequency.top_k_share(h, 64)
    for name in list(w3)[:2]:
        log(f"  {name}: top-64 share {top64[name]:.1%}")

    if ckpt_dir:
        ckpt.save({"params": params}, ckpt_dir, steps, compress_binary=True)
        log(f"compressed checkpoint written to {ckpt_dir}")
    return {"cfg": cfg, "params": params, "losses": losses, "data": data,
            "logits": logits, "accuracy": acc, "report": rep,
            "compressed": cts, "top64": top64}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)
    workflow(args.steps, args.batch, args.device, args.ckpt_dir)


if __name__ == "__main__":
    main()

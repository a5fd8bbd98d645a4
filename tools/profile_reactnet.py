#!/usr/bin/env python3
"""Device time of ReActNet-A forwards on the card, by conv mode.

    python3 tools/profile_reactnet.py [--src DIR]

Builds ReActNet-A at its published shapes with random weights and 32
images from seed 0 (as ``chip_smoke.py`` does), profiles a warm
``packed`` and ``compressed`` forward ``REPEAT`` times each with
:func:`profile_forward` (which ``chip_smoke.py::profile_reactnet`` uses
too), and prints per mode the device busy time of each run and the
device time of every kernel of the port's ``csrc`` (by kernel name), as
one JSON object a line.  ``--src`` imports the port from another
checkout's ``src`` directory, so two commits can be compared in one run
on one card (run them in turns: A, B, B, A).  It uses only the port's
public ReActNet API, which both commits share.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 32
REPEAT = 3      # profiled forwards a mode
SESSIONS = 2    # profiler sessions a forward; the fuller one is kept
PORT_KERNELS = ("binarize_pack", "binary_contraction", "fused_decode")


def profile_forward(forward) -> tuple[float, float, list, object]:
    """Run ``forward()`` (one warm forward) under ``torch.profiler``
    ``SESSIONS`` times and keep the session that saw the most kernel
    launches: a session now and then loses kernels.  Returns its wall ms,
    its device busy ms (the kernels' own device time summed; 0 where it
    saw none), its kernels as ``(name, device ms, launches)`` and its
    ``key_averages()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    best = None
    for _ in range(SESSIONS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            forward()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
        averages = prof.key_averages()
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in averages
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        launched = sum(n for _, _, n in rows)
        if best is None or launched > best[0]:
            best = (launched, wall_ms, rows, averages)
    _, wall_ms, rows, averages = best
    return wall_ms, sum(ms for _, ms, _ in rows), rows, averages


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the checkout's src directory to import the port "
                         "from")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this needs a GPU")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.models import reactnet as rn

    dev = torch.device("cuda", 0)
    params = rn.init_params(rn.CONFIG,
                            torch.Generator(device=dev).manual_seed(0), dev)
    images = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (BATCH, rn.CONFIG.image_size, rn.CONFIG.image_size, 3)).astype(
            np.float32)).to(dev)
    comp = rn.prepare_compressed(params, cluster=False)
    for mode in ("packed", "compressed"):
        cfg = dataclasses.replace(rn.CONFIG, conv_mode=mode)
        c = comp if mode == "compressed" else None
        for _ in range(2):                      # build and warm up
            rn.forward(cfg, params, images, compressed=c)
        torch.cuda.synchronize()
        busy, kernel_ms = [], []
        for _ in range(REPEAT):
            _, ms, rows, _ = profile_forward(
                lambda: rn.forward(cfg, params, images, compressed=c))
            busy.append(ms)
            kernel_ms.append({name: sum(t for key, t, _ in rows
                                        if name in key)
                              for name in PORT_KERNELS})
        print(json.dumps({
            "src": os.path.abspath(args.src), "mode": mode,
            "gpu": torch.cuda.get_device_name(0),
            "device_busy_ms": busy, "kernel_ms": kernel_ms}), flush=True)


if __name__ == "__main__":
    main()
